"""The port's config validation against the JAX package's: the same decks pass, the same fail, with the same
message.

Parametrized over every deck pair of ``configs/`` and ``tests/configs/`` in
every mode, and over the cases of ``tests/test_utils/test_schema.py`` (each a
change to the main deck).  One departure: the JAX package accepts any
optimizer name that ``optax`` has; the port takes the names its loops take
(adam, lbfgs, l-bfgs-b, and the optax names of ``inverse.optimizers.METHODS``
for the angular loop) and refuses the others with the JAX package's message
for a name that is not optax's, followed by the list of the optax names it
takes.
"""

import copy
import os

import pytest
import yaml

from tsadar_tpu.utils.schema import ConfigError as JaxConfigError
from tsadar_tpu.utils.schema import validate_config as jax_validate
from tsadar_tpu_torch.utils.config import merge_configs
from tsadar_tpu_torch.inverse.optimizers import METHODS
from tsadar_tpu_torch.utils.schema import PORTED_OPTAX, ConfigError, validate_config

ROOT = os.path.join(os.path.dirname(__file__), "..")
TESTS = os.path.join(ROOT, "tests", "configs")


def _load(*paths):
    decks = [yaml.safe_load(open(p)) for p in paths]
    return merge_configs(*decks) if len(decks) == 2 else decks[0]


DECKS = {
    **{f"configs/{d}": (os.path.join(ROOT, "configs", d, "defaults.yaml"), os.path.join(ROOT, "configs", d, "inputs.yaml"))
       for d in ("1d", "1d_series", "arts-1d", "arts-2d")},
    "tests/1d": (os.path.join(TESTS, "1d-defaults.yaml"), os.path.join(TESTS, "1d-inputs.yaml")),
    "tests/arts1v": (os.path.join(TESTS, "arts1v_test_defaults.yaml"), os.path.join(TESTS, "arts1v_test_inputs.yaml")),
    "tests/arts2v": (os.path.join(TESTS, "arts2v_test_defaults.yaml"), os.path.join(TESTS, "arts2d_test_inputs.yaml")),
    "tests/time_test": (os.path.join(TESTS, "time_test_defaults.yaml"), os.path.join(TESTS, "time_test_inputs.yaml")),
    "tests/detector": (os.path.join(TESTS, "detector_inputs.yaml"),),
}


def _outcome(validate, error, cfg, mode):
    try:
        validate(cfg, mode=mode)
    except error as e:
        return str(e)
    return None


def _same(cfg, mode):
    """Both validators on their own copy of ``cfg``: the port's outcome (None, or its message).  Where the
    optimizer's name is refused, the port's message goes on to list the optax names it takes."""
    got = _outcome(validate_config, ConfigError, copy.deepcopy(cfg), mode)
    want = _outcome(jax_validate, JaxConfigError, copy.deepcopy(cfg), mode)
    assert got == (want + PORTED_OPTAX if want is not None and want.startswith("optimizer.method") else want)
    return got


@pytest.mark.parametrize("mode", ["fit", "forward", "series"])
@pytest.mark.parametrize("deck", list(DECKS))
def test_every_deck_of_the_repo(deck, mode):
    assert _same(_load(*DECKS[deck]), mode) is None


def _set(path, value):
    def change(cfg):
        cur = cfg
        for k in path[:-1]:
            cur = cur[k]
        cur[path[-1]] = value

    return change


def _update(path, **values):
    def change(cfg):
        cur = cfg
        for k in path:
            cur = cur[k]
        cur.update(values)

    return change


def _delete(key):
    return lambda cfg: cfg.pop(key)


# (change to the main deck, mode, the key path the message names, or None where the deck passes)
CASES = {
    "typo_in_fe_type": (_set(("parameters", "electron", "fe", "type"), "dlmm"), "fit", "parameters.electron.fe.type"),
    "bad_spectype": (_set(("other", "extraoptions", "spectype"), "tempral"), "fit", "other.extraoptions.spectype"),
    "bad_background_type": (_set(("data", "background", "type"), "pixle"), "fit", "data.background.type"),
    "bad_optimizer_method": (_set(("optimizer", "method"), "adamm"), "fit", "optimizer.method"),
    "non_numeric_val": (_set(("parameters", "electron", "Te", "val"), "hot"), "fit", "parameters.electron.Te.val"),
    "inverted_bounds_active": (_update(("parameters", "electron", "Te"), active=True, lb=2.0, ub=1.0), "fit",
                               "parameters.electron.Te"),
    "inverted_bounds_inactive": (_update(("parameters", "electron", "Te"), active=False, lb=1.0, ub=1.0), "fit", None),
    "missing_optimizer_for_fit": (_delete("optimizer"), "fit", "optimizer"),
    "missing_data_for_fit": (_delete("data"), "fit", "data"),
    "forward_without_optimizer": (_delete("optimizer"), "forward", None),
    "bad_batch_size": (_set(("optimizer", "batch_size"), -4), "fit", "optimizer.batch_size"),
    "bad_ccdsize_shape": (_set(("other", "CCDsize"), [1024]), "fit", "other.CCDsize"),
    "rmsprop": (_set(("optimizer", "method"), "rmsprop"), "fit", None),
    "not_a_mapping": (lambda cfg: cfg.clear() or cfg.update(parameters=[]), "fit", "parameters"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_jax_packages_schema_cases(case):
    change, mode, path = CASES[case]
    cfg = _load(*DECKS["tests/time_test"])
    change(cfg)
    message = _same(cfg, mode)
    if path is None:
        assert message is None
    else:
        assert message is not None and message.startswith(path), message


@pytest.mark.parametrize("bad", [[], None, "deck"])
def test_a_config_that_is_not_a_mapping(bad):
    assert _same(bad, "fit").startswith("config must be a mapping")


@pytest.mark.parametrize("method", ["chain", "scale_by_adam", "clip_by_global_norm"])
def test_optax_names_the_port_does_not_take(method):
    """A deliberate departure (ROADMAP.md §3): the JAX package takes any callable of optax by name, these too, which
    are no optimizer; the port takes every optimizer of optax's aliases, refuses any other name and lists those it
    takes (until every optimizer was ported, lamb, novograd and adafactor were refused here)."""
    cfg = _load(*DECKS["tests/time_test"])
    cfg["optimizer"]["method"] = method
    jax_validate(copy.deepcopy(cfg), mode="fit")
    with pytest.raises(ConfigError) as e:
        validate_config(cfg, mode="fit")
    assert str(e.value) == (f"optimizer.method: {method!r} is not one of ('adam', 'lbfgs', 'l-bfgs-b') or an optax "
                            f"optimizer; the port takes these optax optimizers: {METHODS + ('polyak_sgd',)}")


@pytest.mark.parametrize("method", ["adam", "lbfgs", "l-bfgs-b", "rmsprop", "sgd", "adamw", "adamax", "adagrad", "adabelief",
                                    "amsgrad", "nadam", "lion", "yogi", "radam", "lamb", "novograd", "adafactor", "sm3",
                                    "noisy_sgd", "polyak_sgd"])
def test_the_names_the_ports_loops_take(method):
    cfg = _load(*DECKS["tests/time_test"])
    cfg["optimizer"]["method"] = method
    assert _same(cfg, "fit") is None
