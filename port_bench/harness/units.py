"""The units of work a window repeats, one kind to a traffic mix's ``"unit"``.

* ``fit``: ``tsadar_tpu_torch.inverse.loops.one_d_loop`` over the lineouts that
  ``fitter.load_data_for_fitting`` prepared in set-up: one whole fit of the batch;
* ``run``: ``tsadar_tpu_torch.runner.run(<deck directory>, "fit")``: a new tracked run
  that prepares, fits, takes the sigmas and writes its files.

Every unit starts from its own start values, drawn from the seed and the unit's
index in a narrow band around the deck's values (the configuration's
``assumed.start_band``), inside the deck's bounds.  The amount of work does
not depend on the draw.
"""

import copy
import glob
import os
import shutil
import time
from pathlib import Path

import numpy as np
import yaml


def start_values(deck_parameters, band, seed, index):
    """{(group, name): start value}: the deck's value of each parameter named in ``band`` times 1 + u band[name],
    u uniform on [-1, 1] from (seed, index), kept inside the parameter's bounds."""
    rng = np.random.default_rng(np.random.SeedSequence([abs(int(seed)), int(seed < 0), int(index)]))
    values = {}
    for key in sorted(band):
        group, name = key.split(".")
        entry = deck_parameters[group]["fe"]["params"][name] if name == "m" else deck_parameters[group][name]
        v = float(entry["val"]) * (1.0 + band[key] * rng.uniform(-1.0, 1.0))
        values[(group, name)] = float(np.clip(v, entry.get("lb", -np.inf), entry.get("ub", np.inf)))
    return values


def with_values(parameters, values):
    """A copy of the deck's ``parameters`` with ``values`` as the start values."""
    parameters = copy.deepcopy(parameters)
    for (group, name), v in values.items():
        entry = parameters[group]["fe"]["params"][name] if name == "m" else parameters[group][name]
        entry["val"] = v
    return parameters


def cell_decks(config, traffic):
    """(defaults, inputs) of the cell: the configuration's decks with the traffic's lineouts and batch."""
    defaults, inputs = copy.deepcopy(config["decks"]["defaults"]), copy.deepcopy(config["decks"]["inputs"])
    if "lineouts" in traffic:
        data = inputs.setdefault("data", {})
        data["lineouts"] = {**defaults["data"]["lineouts"], **data.get("lineouts", {}), **traffic["lineouts"]}
        sel = data["lineouts"]
        inputs.setdefault("optimizer", {})["batch_size"] = len(range(sel["start"], sel["end"], sel["skip"]))
    return defaults, inputs


class FitUnits:
    """Whole fits of one prepared lineout batch (``one_d_loop``, one batch)."""

    kind = "fit"

    def __init__(self, config, traffic, seed, device=None):
        from tsadar_tpu_torch.inverse import fitter
        from tsadar_tpu_torch.utils.config import merge_configs

        self.seed, self.device, self.band = seed, device, config["assumed"]["start_band"]
        defaults, inputs = cell_decks(config, traffic)
        self.source_deck = merge_configs(defaults, inputs)  # what the reference prepares anew
        deck = fitter._lineout_selection(copy.deepcopy(self.source_deck))
        t0 = time.perf_counter()
        self.all_data, self.sa, _ = fitter.load_data_for_fitting(deck)
        self.prepare_s = time.perf_counter() - t0
        self.deck = deck
        self.n = len(deck["data"]["lineouts"]["val"])
        self.warmup_epochs = traffic["warmup_epochs"]

    def values(self, i):
        return start_values(self.deck["parameters"], self.band, self.seed, i)

    def _fit(self, deck, record):
        from tsadar_tpu_torch.inverse.loops import one_d_loop

        weights, loss, _ = one_d_loop(deck, self.all_data, self.sa, np.arange(self.n), 1, device=self.device, record=record)
        return weights[0], loss

    def warm(self):
        """A short fit of the same batch (every shape of the window, kernels loaded, FFT plans made)."""
        deck = copy.deepcopy(self.deck)
        deck["optimizer"]["num_epochs"] = self.warmup_epochs
        self._fit(deck, {})

    def __call__(self, i):
        deck = copy.deepcopy(self.deck)
        deck["parameters"] = with_values(deck["parameters"], self.values(i))
        record = {}
        weights, loss = self._fit(deck, record)
        return {"index": i, "loss": float(loss), "losses": record["losses"], "epochs": len(record["losses"]),
                "weights": weights}

    def answer(self, result):
        """The fitted leaves of a unit as numpy (after the window)."""
        return {k: v.detach().cpu().numpy() for k, v in result["weights"].state_dict().items()}

    def close(self):
        self.all_data = None


class RunUnits:
    """Whole runs of the decks through the normal entry point (``runner.run``), each a new tracked run."""

    kind = "run"
    n = 1  # one image

    def __init__(self, config, traffic, seed, workdir, device=None):
        from tsadar_tpu_torch.utils.config import merge_configs

        self.seed, self.device, self.band = seed, device, config["assumed"]["start_band"]
        self.defaults, self.inputs = cell_decks(config, traffic)
        self.source_deck = merge_configs(copy.deepcopy(self.defaults), copy.deepcopy(self.inputs))
        self.workdir = Path(workdir)
        self.warmup_epochs = traffic["warmup_epochs"]
        self.runs_dir = Path(os.environ["TSADAR_RUNS_DIR"])
        self.prepare_s = None

    def values(self, i):
        return start_values(self.source_deck["parameters"], self.band, self.seed, i)

    def _decks(self, name, values=None, epochs=None):
        inputs = copy.deepcopy(self.inputs)
        if values is not None:
            # the inputs deck holds every parameter the cell starts from (the configuration's file says so)
            inputs["parameters"] = with_values(inputs["parameters"], values)
        if epochs is not None:
            inputs["optimizer"]["num_epochs"] = epochs
        directory = self.workdir / name
        directory.mkdir(parents=True, exist_ok=True)
        for deck_name, deck in (("defaults", self.defaults), ("inputs", inputs)):
            (directory / f"{deck_name}.yaml").write_text(yaml.safe_dump(deck))
        return str(directory)

    def _run(self, cfg_dir, record):
        from tsadar_tpu_torch import runner

        return runner.run(cfg_dir, "fit", device=self.device, record=record)

    def warm(self):
        """A short run of the same decks: the data pipeline, a few fit steps, the sigmas and the files."""
        self._run(self._decks("warm", epochs=self.warmup_epochs), {})

    def __call__(self, i):
        cfg_dir = self._decks(f"unit{i % 2}", self.values(i))
        record = {}
        run_id = self._run(cfg_dir, record)
        ang = record["angular"]
        return {"index": i, "run_id": run_id, "losses": ang["losses"], "epochs": len(ang["losses"]) + ang["start_epoch"],
                "setup_seconds": record["setup_seconds"], "fit_seconds": record["fit_seconds"],
                "postprocess_seconds": record["postprocess_seconds"],
                "hessian_seconds": record.get("recalc_hessian_seconds", 0.0),
                "arrayloss_seconds": record.get("recalc_arrayloss_seconds", 0.0), "sigma_error": record.get("sigma_error"),
                "answer_losses": np.asarray(record["losses"], dtype=float)}

    def run_dir(self, run_id):
        found = glob.glob(str(self.runs_dir / "*" / f"*-{run_id}"))
        if len(found) != 1:
            raise FileNotFoundError(f"run {run_id}: {found}")
        return Path(found[0])

    def answer(self, result):
        """{(group, name): fitted value} of every parameter of the band, and the sigmas [P], as the run's files hold them."""
        arts = self.run_dir(result["run_id"]) / "artifacts"
        rows = (arts / "csv" / "learned_parameters.csv").read_text().splitlines()
        columns = dict(zip(rows[0].split(","), rows[1].split(",")))
        fitted = {(group, name): float(columns[f"{name}_{group}"]) for group, name in (k.split(".") for k in self.band)}
        sigmas = np.load(arts / "binary" / "sigmas_fe.npz")["sigmas"].reshape(-1)
        return {"fitted": fitted, "sigmas": sigmas}

    def close(self):
        shutil.rmtree(self.runs_dir, ignore_errors=True)
        shutil.rmtree(self.workdir, ignore_errors=True)
