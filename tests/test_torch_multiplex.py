"""The multiplexed two-shot angular fit against the JAX package's, on the CPU in float64.

The port's counterpart of ``tests/test_inverse/test_multiplex.py``, at its
sizes (the ARTS 2V deck with the arbitrary 2D EDF, nvx 32, npts 256, a
256 x 256 CCD, ``shot_rot`` 25 degrees, the resolution-unit window 5:15):

* the loss and its gradient with respect to ``fval`` over ``{"b1", "b2"}``
  (two seeded images; the second's theory is the EDF turned by ``shot_rot``)
  against ``LossFunction._vg_func_``, at the deck's start and at a skewed
  EDF with the moment penalties on (``optimizer.moment_loss``, whose 2V
  first moments vanish only for a symmetric EDF): the gradient to 1e-8 of
  its largest entry, the first image's theory to 1e-9 of its peak;
* ``angular_optax`` on the multiplexed data (the second shot in the ``*_rot``
  channels): three adam steps against optax's over the JAX loss, every loss to
  1e-9 relative;
* a list ``data.shotnum`` through ``load_data_for_fitting``: the JAX package
  fails in ``loadData`` (its ``prepare_data`` loads ``data.shotnum``, the
  list, not its shot argument) and, for a deck whose spectype is not yet
  ``angular_full``, before it; the port fails at the same points, naming the
  fault (ROADMAP.md §3);
* ``fitter.prepare_multiplexed`` on shots 94475 and 94477 (the repository's
  two ATS shots): each prepared on its own, into the same 103 x 205 image of
  resolution units as ``prepare_data`` gives it alone.
"""

import copy
import os

import jax
import numpy as np
import optax
import pytest
import torch
import yaml
from jax import numpy as jnp

from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.core.params import combine, partition
from tsadar_tpu.core.params import get_filter_spec as jax_filter_spec
from tsadar_tpu.inverse import fitter as jax_fitter
from tsadar_tpu.inverse.loss import LossFunction as JaxLoss
import tsadar_tpu_torch as port
from tsadar_tpu_torch.convert import leaves_by_path, thomson_params_from_partitions
from tsadar_tpu_torch.inverse import fitter
from tsadar_tpu_torch.utils.config import merge_configs, set_forward_ranges
from tsadar_tpu_torch.utils.process.prepare import prepare_data

from .test_torch_data_pipeline import same_scipy_fits
from .torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CONFIGS = os.path.join(os.path.dirname(__file__), "configs")
FVAL = ".electron.distribution_functions.fval"
SIZE, WINDOW, SHOTS = 256, (5, 15), [94475, 94477]


def _decks():
    return [yaml.safe_load(open(os.path.join(CONFIGS, n))) for n in ("arts2v_test_defaults.yaml", "arts2d_test_inputs.yaml")]


def _config(moments=False):
    cfg = set_forward_ranges(merge_configs(*_decks()))
    cfg["other"].update(npts=SIZE, CCDsize=[SIZE, SIZE])
    cfg["data"].update(shotnum=list(SHOTS), shot_rot=25.0)
    cfg["parameters"]["electron"]["fe"].update(type="arbitrary", dim=2, nvx=32, params=dict(init_m=2.5, learn_log=True))
    cfg["data"]["lineouts"].update(start=WINDOW[0], end=WINDOW[1])
    cfg["optimizer"]["moment_loss"] = moments
    sas = port.get_scattering_angles(cfg)
    sas["angAxis"] = port.get_calibrations(104000, cfg["other"]["extraoptions"]["spectype"], 0.0, cfg["other"]["CCDsize"])[0]
    cfg["other"]["extraoptions"]["spectype"] = "angular_full"
    return cfg, sas


def _image(seed, n_units):
    rng = np.random.default_rng(seed)
    return {"e_data": rng.uniform(0.1, 1.0, (n_units, SIZE)), "e_amps": np.ones((n_units, 1)), "i_data": np.ones((1, SIZE)),
            "i_amps": np.ones((1, 1)), "noise_e": 0.01 * rng.uniform(0.0, 1.0, (n_units, SIZE)), "noise_i": np.zeros((1, SIZE))}


def _jax_params(cfg, skew):
    jp = JaxParams.create(cfg["parameters"], num_params=1, batch=False, activate=True)
    diff, static = partition(jp, jax_filter_spec(cfg["parameters"], jp))
    if skew:  # a seeded, non-symmetric change of the EDF's log values
        v = np.linspace(-1.0, 1.0, 32)
        bump = 0.3 * v[None, :] + 0.2 * v[:, None] ** 3 + 0.05 * np.random.default_rng(2).standard_normal((32, 32))
        diff = jax.tree.map(lambda x: x + bump if np.shape(x) == (32, 32) else x, diff)
    return diff, static


@pytest.mark.parametrize("case", ["start", "skewed_with_moments"])
def test_multiplexed_loss_and_gradient_match_jax(case):
    skew = case != "start"
    cfg, sas = _config(moments=skew)
    n_units = WINDOW[1] - WINDOW[0]
    b1, b2 = _image(0, n_units), _image(1, n_units)
    batch = {"b1": b1, "b2": b2}
    jloss = JaxLoss(cfg, sas, b1)
    assert jloss.multiplex_ang
    diff, static = _jax_params(cfg, skew)
    (want, aux), g_ref = jloss._vg_func_(diff, static, batch)
    g_ref = leaves_by_path(g_ref)[FVAL]
    assert np.isfinite(g_ref).all() and np.abs(g_ref).max() > 0

    loss_fn = port.LossFunction(cfg, sas, b1, device="cpu")
    assert loss_fn.multiplex_ang
    tp = thomson_params_from_partitions(cfg["parameters"], diff, static, activate=True, device="cpu")
    (value, paux), grads = loss_fn.value_and_grad(tp, batch)
    np.testing.assert_allclose(float(value), float(want), rtol=1e-10)
    ThryE = np.asarray(aux[0])
    np.testing.assert_allclose(paux[0].numpy(), ThryE, rtol=0, atol=1e-9 * ThryE.max())
    np.testing.assert_allclose(grads[FVAL].numpy(), g_ref, rtol=0, atol=1e-8 * np.abs(g_ref).max())
    np.testing.assert_allclose(paux[2].numpy(), np.asarray(aux[2]), rtol=1e-9)
    if skew:
        penalties = [float(p) for p in jloss.moment_penalties(combine(diff, static)())]
        assert penalties[2] > 0.0  # the first moments of the skewed EDF
        got = loss_fn.moment_penalties(tp())
        np.testing.assert_allclose([float(p) for p in got], penalties, rtol=1e-10, atol=1e-15)  # the density term is ~0


def test_multiplexed_angular_loop_matches_optax():
    cfg, sas = _config()
    n_units = WINDOW[1] - WINDOW[0]
    b1, b2 = _image(0, n_units), _image(1, n_units)
    jloss = JaxLoss(cfg, sas, b1)
    diff, static = _jax_params(cfg, False)
    opt = optax.adam(2e-3)
    state, want = opt.init(diff), []
    for _ in range(3):
        (value, _), grad = jloss._vg_func_(diff, static, {"b1": b1, "b2": b2})
        updates, state = opt.update(grad, state)
        diff = optax.apply_updates(diff, updates)
        want.append(float(value))

    # the whole images: the window is cut from them, in units of ang_res_unit (1 here)
    def whole(image, other):
        full = {k: np.zeros((SIZE, SIZE)) for k in ("e_data", "noiseE", "noiseI")}
        full["e_amps"] = np.ones((SIZE, 1))
        full["e_data"][slice(*WINDOW)], full["noiseE"][slice(*WINDOW)] = image["e_data"], image["noise_e"]
        return full if other is None else {k + "_rot": full[k] for k in ("e_data", "e_amps", "noiseE")}

    all_data = whole(b1, None) | whole(b2, True) | {"i_data": b1["i_data"], "i_amps": b1["i_amps"]}
    cfg["other"]["ang_res_unit"] = 1
    cfg["optimizer"].update(method="adam", learning_rate=2e-3, num_epochs=3)
    record = {}
    port.angular_optax(cfg, all_data, sas, device="cpu", record=record)
    np.testing.assert_allclose(record["losses"], want, rtol=1e-9)


def _real_deck(spectype):
    cfg = merge_configs(*_decks())
    cfg["data"].update(shotnum=list(SHOTS), shot_rot=25.0, background={"type": "Fit", "slice": 94477})
    cfg["other"]["extraoptions"]["spectype"] = spectype
    return fitter._lineout_selection(cfg)


@pytest.mark.parametrize("spectype", ["angular", "angular_full"])
def test_a_list_shot_fails_where_the_jax_package_fails(spectype):
    if spectype == "angular":
        for load in (jax_fitter.load_data_for_fitting, fitter.load_data_for_fitting):
            with pytest.raises(NotImplementedError, match="^Multiplexed data fitting is only available for angular data$"):
                load(_real_deck(spectype))
        return
    with pytest.raises(LookupError, match=r"No data found for shotnumber \[94475, 94477\]"):
        jax_fitter.load_data_for_fitting(_real_deck(spectype))
    with pytest.raises(NotImplementedError, match="loads data.shotnum, not shotNum") as e:
        fitter.load_data_for_fitting(_real_deck(spectype))
    assert "prepare_multiplexed" in str(e.value)
    cfg = _real_deck(spectype)
    cfg["optimizer"]["num_epochs"] = 1
    with pytest.raises(NotImplementedError, match="loads data.shotnum"):  # fitter.fit stops there too
        fitter.fit(cfg, device="cpu")


def test_prepare_multiplexed_prepares_each_shot_on_its_own():
    cfg = _real_deck("angular")
    with same_scipy_fits():
        all_data, sa, axes = fitter.prepare_multiplexed(cfg)
        alone = {}
        for shot in SHOTS:
            one = copy.deepcopy(_real_deck("angular"))
            one["data"]["shotnum"] = shot
            alone[shot] = prepare_data(one, shot)[0]
    assert cfg["data"]["shotnum"] == SHOTS and cfg["other"]["extraoptions"]["spectype"] == "angular_full"
    assert all_data["e_data"].shape == all_data["e_data_rot"].shape == (103, 205)
    assert all_data["rot_angle"] == 25.0
    for key in ("e_data", "e_amps", "noiseE"):
        np.testing.assert_array_equal(all_data[key], alone[94475][key], err_msg=key)
        np.testing.assert_array_equal(all_data[key + "_rot"], alone[94477][key], err_msg=key)
    assert not np.array_equal(all_data["e_data"], all_data["e_data_rot"])
    assert torch.is_tensor(torch.as_tensor(sa["angAxis"])) and len(axes["epw_x"]) == 103
