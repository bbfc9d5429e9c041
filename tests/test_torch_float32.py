"""The port's float32 forward against the JAX package's float32 forward, on the CPU.

The whole-shot deck (npts 5120, P9's 10 angles, a DLM EDF on nvx = 320) is run
for single lineouts in four ways: JAX in float64 (the reference), JAX in
float32, and the port in float64 and float32.  Where the EPW resonance is narrow
(lower Te, higher ne, flat-topped EDFs, all inside the deck's bounds) float32
misses float64 by percents to tens of percent of peak.  The test holds the
port's float32 miss to at most 1.1 times the JAX package's own, plus 1e-4 of
peak, so that a loss of accuracy on the card can be put down to float32 and not
to the port.  ``pytest -s`` prints the misses.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from tsadar_tpu.core.diagnostic import ThomsonScatteringDiagnostic as JaxDiagnostic
from tsadar_tpu.core.params import ThomsonParams as JaxParams
from tsadar_tpu.utils.data_handling.calibration import get_scattering_angles as jax_angles
import tsadar_tpu_torch as port
from tsadar_tpu_torch.utils.config import merge_configs, set_forward_ranges

CONFIGS = os.path.join(os.path.dirname(__file__), "configs")
# (Te keV, ne 1e20 cm^-3, DLM m, probe lam nm): four narrow-resonance lineouts,
# then shot 101675's fitted values, where float32 is adequate
LINEOUTS = [(0.32, 0.52, 3.3, 526.0), (0.54, 0.60, 4.4, 526.0), (0.62, 0.51, 4.9, 526.0), (0.89, 0.57, 4.55, 526.0),
            (0.6, 0.2, 3.0, 526.5)]
RATIO, FLOOR = 1.1, 1e-4
BATCH = {"e_amps": np.ones((1, 1)), "i_amps": np.ones((1, 1)), "noise_e": np.zeros((1, 1)), "noise_i": np.zeros((1, 1))}


def _cfg(Te, ne, m, lam):
    decks = [yaml.safe_load(open(os.path.join(CONFIGS, f"time_test_{n}.yaml"))) for n in ("defaults", "inputs")]
    cfg = copy.deepcopy(set_forward_ranges(merge_configs(*decks)))
    cfg["parameters"]["electron"]["Te"]["val"] = Te
    cfg["parameters"]["electron"]["ne"]["val"] = ne
    cfg["parameters"]["electron"]["fe"]["params"]["m"]["val"] = m
    cfg["parameters"]["general"]["lam"]["val"] = lam
    return cfg


def _jax(cfg, x64):
    with jax.enable_x64(x64):
        diag = JaxDiagnostic(cfg, scattering_angles=jax_angles(cfg))
        params = JaxParams.create(cfg["parameters"], num_params=1, batch=True, activate=True)
        ThryE = np.asarray(jax.jit(lambda p, b: diag(p, b)[0])(params, BATCH))
    assert ThryE.dtype == (np.float64 if x64 else np.float32)
    return ThryE.astype(np.float64)


def _port(cfg, dtype):
    with torch.no_grad():
        diag = port.ThomsonScatteringDiagnostic(cfg, port.get_scattering_angles(cfg), device="cpu", dtype=dtype)
        ThryE = diag(port.ThomsonParams.create(cfg["parameters"], 1, activate=True, device="cpu", dtype=dtype), BATCH)[0]
    assert ThryE.dtype == dtype
    return ThryE.double().numpy()


@pytest.mark.parametrize("lineout", LINEOUTS, ids=lambda p: "Te{}-ne{}-m{}-lam{}".format(*p))
def test_port_float32_no_worse_than_jax_float32(lineout):
    cfg = _cfg(*lineout)
    ref = _jax(cfg, True)
    peak = np.abs(ref).max()
    miss = lambda x: float(np.abs(x - ref).max() / peak)  # noqa: E731
    port64, jax32, port32 = miss(_port(cfg, torch.float64)), miss(_jax(cfg, False)), miss(_port(cfg, torch.float32))
    print(f"{lineout}: of peak, float32 vs float64: JAX {jax32:.4e}, port {port32:.4e}; port float64 {port64:.1e}")
    assert port64 <= 1e-8
    assert port32 <= RATIO * jax32 + FLOOR
