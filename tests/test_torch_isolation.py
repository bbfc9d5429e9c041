"""The PyTorch port stands alone: no JAX, nothing of the JAX package, no quiet CPU fallback."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tsadar_tpu_torch as port
from tsadar_tpu_torch.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tsadar_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "tsadar_tpu")


def _forbidden(module):
    return module is not None and any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _clean_env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, tsadar_tpu_torch, tsadar_tpu_torch.convert\n"
        "from tsadar_tpu_torch.ops import build, cubic_lookup, lin_lookup, spectrum_tail\n"
        f"print([m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r})])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(), capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None legitimately resolves to it")
    cfg = {"parameters": {}, "other": {"extraoptions": {"spectype": "temporal"}}}
    for call in (
        lambda: resolve_device(None),
        lambda: port.ThomsonScatteringDiagnostic(cfg, {"sa": np.ones(10), "weights": np.ones(10)}),
        lambda: port.ThomsonParams.create({}, 2),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, shutil.copy(ROOT / "chip_smoke.py", tmp_path))):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=_clean_env(), capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and out.stdout == ""
