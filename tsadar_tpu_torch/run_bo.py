"""Bayesian optimization over whole fits: ``python -m tsadar_tpu_torch.run_bo``.

Counterpart of the repository's ``run_BO.py``: it maximizes the negative loss
of complete ``fitter.fit`` runs over (``dist_fit.window.len``,
``optimizer.grad_scalar``) in [0.1, 0.95]^2, each probe a tracked run of its
own (``utils.mlflow_shim``) that logs its two decks, the merged config, its
seconds and its status.  ``SimpleBayesOpt`` is the same numpy/scipy GP (RBF
kernel, length scale 0.2) with expected improvement: on one seed it draws and
probes the same points as ``run_BO.SimpleBayesOpt``.

No fitter of either package reads ``dist_fit.window.len`` or
``optimizer.grad_scalar``, so every probe fits the same deck; the port keeps
that for parity (ROADMAP.md §3).

    python -m tsadar_tpu_torch.run_bo [--cfg DIR] [--init_points 2] [--n_iter 3] [--device cuda|cpu]

``--cfg`` names the directory of ``defaults.yaml`` and ``inputs.yaml`` (the
working directory by default, as ``run_BO.py`` reads them); runs land under
``$TSADAR_RUNS_DIR`` in the deck's ``mlflow.experiment``, each named after its
``mlflow.run``.  It prints the best probe as ``{"target": ..., "params": {...}}``.
"""

import argparse
import json
import multiprocessing as mp
import os
import tempfile
import time

import numpy as np
import yaml

PBOUNDS = {"window_factor": (0.1, 0.95), "grad_scalar": (0.1, 0.95)}


class SimpleBayesOpt:
    """GP (RBF kernel) + expected improvement on a box-bounded space: ``maximize(init_points, n_iter)``."""

    def __init__(self, f, pbounds, random_state=42, noise=1e-6):
        self.f = f
        self.keys = sorted(pbounds)
        self.lo = np.array([pbounds[k][0] for k in self.keys])
        self.hi = np.array([pbounds[k][1] for k in self.keys])
        self.rng = np.random.default_rng(random_state)
        self.noise = noise
        self.X, self.y = [], []

    def _kernel(self, A, B, ls=0.2):
        d2 = np.sum((A[:, None, :] - B[None, :, :]) ** 2, axis=-1)
        return np.exp(-0.5 * d2 / ls**2)

    def _ei(self, Xq):
        """Expected improvement over the best target so far at the normalized candidates Xq."""
        from scipy.stats import norm

        X, y = np.array(self.X), np.array(self.y)
        Kinv = np.linalg.inv(self._kernel(X, X) + self.noise * np.eye(len(X)))
        kq = self._kernel(Xq, X)
        mu = kq @ Kinv @ y
        sd = np.sqrt(np.maximum(1.0 - np.sum(kq @ Kinv * kq, axis=1), 1e-12))
        z = (mu - y.max()) / sd
        return (mu - y.max()) * norm.cdf(z) + sd * norm.pdf(z)

    def probe(self, x):
        val = self.f(**dict(zip(self.keys, x)))
        self.X.append((np.asarray(x) - self.lo) / (self.hi - self.lo))
        self.y.append(val)
        return val

    def maximize(self, init_points=2, n_iter=3, candidates=256):
        """``init_points`` random probes, then ``n_iter`` at the candidate of largest expected improvement."""
        for _ in range(init_points):
            self.probe(self.lo + self.rng.random(len(self.keys)) * (self.hi - self.lo))
        for _ in range(n_iter):
            Xq = self.rng.random((candidates, len(self.keys)))
            self.probe(self.lo + Xq[np.argmax(self._ei(Xq))] * (self.hi - self.lo))
        i = int(np.argmax(self.y))
        return {"target": self.y[i], "params": dict(zip(self.keys, self.lo + np.array(self.X[i]) * (self.hi - self.lo)))}


def one_run(config, device=None):
    """One tracked ``fitter.fit`` of ``config`` (the run tagged ``figures`` as ``runner`` tags it): the negative of
    its loss."""
    from .inverse import fitter
    from .utils import mlflow_shim as mlflow
    from .utils import plotting

    mlflow.log_config(config)
    plotting.figures()
    t0 = time.time()
    _, loss = fitter.fit(config=config, device=device)
    mlflow.log_metrics({"total_time": time.time() - t0, "num_cores": int(mp.cpu_count())})
    mlflow.set_tag("status", "completed")
    return -loss


def bbf_for(all_configs, run_name, device=None):
    """The black-box function of a deck pair: a probe sets the two parameters, logs both decks into a run of
    its own and fits the merged config there."""
    from .utils import mlflow_shim as mlflow
    from .utils.config import merge_configs

    def bbf(window_factor, grad_scalar):
        all_configs["defaults"]["dist_fit"]["window"]["len"] = float(window_factor)
        all_configs["defaults"]["optimizer"]["grad_scalar"] = float(grad_scalar)
        with mlflow.start_run(run_name=run_name):
            with tempfile.TemporaryDirectory() as td:
                for k in ("defaults", "inputs"):
                    with open(os.path.join(td, f"{k}.yaml"), "w") as fi:
                        yaml.dump(all_configs[k], fi)
                mlflow.log_artifacts(td)
            return one_run(merge_configs(all_configs["defaults"], all_configs["inputs"]), device=device)

    return bbf


def main(argv=None):
    """Parse ``argv`` (default: the command line), run the optimization and print its best probe; returns it."""
    from .device import resolve_device
    from .utils import mlflow_shim as mlflow

    parser = argparse.ArgumentParser(prog="python -m tsadar_tpu_torch.run_bo",
                                     description="Bayesian optimization over whole fits")
    parser.add_argument("--cfg", default=".", help="directory containing defaults.yaml and inputs.yaml")
    parser.add_argument("--init_points", type=int, default=2, help="random probes before the GP's")
    parser.add_argument("--n_iter", type=int, default=3, help="probes at the largest expected improvement")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the fits go: the GPU (default) or, when asked, the CPU in float64")
    args = parser.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        parser.error(f"{e} (--device cpu)")

    all_configs = {}
    for k in ("defaults", "inputs"):
        with open(os.path.join(args.cfg, f"{k}.yaml")) as fi:
            all_configs[k] = yaml.safe_load(fi)
    deck = all_configs["inputs"] if "mlflow" in all_configs["inputs"] else all_configs["defaults"]
    mlflow.set_experiment(deck["mlflow"]["experiment"])
    bbf = bbf_for(all_configs, deck["mlflow"]["run"], device=args.device)
    best = SimpleBayesOpt(f=bbf, pbounds=PBOUNDS).maximize(init_points=args.init_points, n_iter=args.n_iter)
    print(json.dumps({"target": float(best["target"]), "params": {k: float(v) for k, v in best["params"].items()}}))
    return best


if __name__ == "__main__":
    main()
