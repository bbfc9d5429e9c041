"""The port's Bayesian optimization over whole fits (``tsadar_tpu_torch.run_bo``) against the repository's ``run_BO.py``.

* ``SimpleBayesOpt``: on one seed and one objective, the port's optimizer
  draws and probes the same points as ``run_BO.SimpleBayesOpt`` (to 1e-12;
  numpy and scipy on both sides, the same arithmetic) and returns the same
  best probe;
* one run of the command line's entry point on the main deck cut to two
  lineouts and 10 adam epochs, ``--device cpu``, one random probe and one
  probe of the GP: two tracked runs, each with its two decks, the merged
  config, ``total_time`` and the status ``completed``; a finite target, the
  negative of ``fitter.fit``'s loss on that deck (every probe fits the same
  deck: no fitter reads the two parameters; ROADMAP.md §3), to 1e-12
  relative, the background fits shared (``same_scipy_fits``).
"""

import json
import os

import numpy as np
import pytest
import yaml

import run_BO
from tsadar_tpu_torch import run_bo
from tsadar_tpu_torch.inverse import fitter
from tsadar_tpu_torch.utils import mlflow_shim
from tsadar_tpu_torch.utils.config import merge_configs

from .test_torch_data_pipeline import same_scipy_fits
from .test_utils.test_runner_paths import _small_decks
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


def _objective(window_factor, grad_scalar):
    return -((window_factor - 0.6) ** 2) - 2.0 * (grad_scalar - 0.3) ** 2 + 0.1 * np.sin(7.0 * window_factor)


@pytest.mark.parametrize("seed", [42, 7])
def test_simple_bayes_opt_probes_as_run_BO_does(seed):
    probes = {}

    def recording(name):
        def f(**kw):
            probes.setdefault(name, []).append((kw["window_factor"], kw["grad_scalar"]))
            return _objective(**kw)
        return f

    want = run_BO.SimpleBayesOpt(recording("jax"), run_bo.PBOUNDS, random_state=seed).maximize(init_points=2, n_iter=4)
    got = run_bo.SimpleBayesOpt(recording("port"), run_bo.PBOUNDS, random_state=seed).maximize(init_points=2, n_iter=4)
    assert len(probes["port"]) == len(probes["jax"]) == 6
    np.testing.assert_allclose(probes["port"], probes["jax"], rtol=1e-12, atol=0)
    assert got["target"] == pytest.approx(want["target"], rel=1e-12)
    for k in run_bo.PBOUNDS:
        assert got["params"][k] == pytest.approx(want["params"][k], rel=1e-12)


def test_one_run_bo_probe_pair_on_a_small_deck(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TSADAR_RUNS_DIR", str(tmp_path / "runs"))
    monkeypatch.setattr(mlflow_shim, "_state", dict(mlflow_shim._state, run_dir=None))
    defaults, inputs = _small_decks()
    defaults["data"]["launch_data_visualizer"] = False
    cfg_dir = tmp_path / "cfg"
    cfg_dir.mkdir()
    for name, deck in (("defaults", defaults), ("inputs", inputs)):
        (cfg_dir / f"{name}.yaml").write_text(yaml.dump(deck))
    with same_scipy_fits():
        best = run_bo.main(["--cfg", str(cfg_dir), "--init_points", "1", "--n_iter", "1", "--device", "cpu"])
        _, loss = fitter.fit(merge_configs(defaults, inputs), device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(best["target"]) and printed["target"] == pytest.approx(best["target"], rel=1e-15)
    np.testing.assert_allclose(best["target"], -loss, rtol=1e-12)
    deck = inputs if "mlflow" in inputs else defaults
    runs = sorted((tmp_path / "runs" / deck["mlflow"]["experiment"]).iterdir())
    assert len(runs) == 2 and all(r.name.startswith(deck["mlflow"]["run"]) for r in runs)
    for run in runs:
        meta = json.loads((run / "run.json").read_text())
        assert meta["tags"]["status"] == "completed"
        assert "total_time" in meta["metrics"] and "optimizer.grad_scalar" in meta["params"]
        assert {"defaults.yaml", "inputs.yaml"} <= set(os.listdir(run / "artifacts"))
    probed = [json.loads((r / "run.json").read_text())["params"]["dist_fit.window.len"] for r in runs]
    assert all(0.1 <= float(p) <= 0.95 for p in probed)
