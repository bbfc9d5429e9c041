"""The PyTorch port stands alone: no JAX, nothing of the JAX package, nothing that the
card's machine lacks (cv2, pandas; matplotlib only inside the functions that draw
figures, never when a module is imported), no quiet CPU fallback."""

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
FORBIDDEN = ("jax", "jaxlib", "optax", "tsadar_tpu", "cv2", "pandas")
AT_MODULE_LEVEL = ("matplotlib",)  # lazily, inside the functions that draw (utils.plotting), never at import


def _forbidden(module, names=FORBIDDEN):
    return module is not None and any(module == f or module.startswith(f + ".") for f in names)


def _imports(nodes):
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _module_level(tree):
    """The statements that run when the module is imported: all but the bodies of functions (and of the classes'
    methods)."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(ast.walk(tree)) if _forbidden(m)]
    bad += [m for m in _imports(_module_level(tree)) if _forbidden(m, AT_MODULE_LEVEL)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_module_level_rule_reads_only_what_runs_at_import():
    tree = ast.parse("import os\ntry:\n    import matplotlib\nexcept ImportError:\n    pass\n"
                     "class A:\n    import matplotlib.colors\n    def f(self):\n        import matplotlib.figure\n"
                     "def g():\n    from matplotlib import animation\n")
    assert sorted(_imports(_module_level(tree))) == ["matplotlib", "matplotlib.colors", "os"]
    assert sorted(_imports(ast.walk(tree))) == ["matplotlib", "matplotlib", "matplotlib.colors", "matplotlib.figure", "os"]


def _clean_env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, tsadar_tpu_torch, tsadar_tpu_torch.convert\n"
        "from tsadar_tpu_torch.ops import build, chi_bilinear, cubic_lookup, lin_lookup, pv_tables, spectrum_tail\n"
        "from tsadar_tpu_torch.inverse import fitter, loops, loss\n"
        "from tsadar_tpu_torch.core.params import distributions, spherical, ts_params\n"
        "from tsadar_tpu_torch.core.physics import form_factor, interp, irf, spectrum\n"
        "from tsadar_tpu_torch import cli, queue, runner\n"
        "from tsadar_tpu_torch.parallel import dist\n"
        "from tsadar_tpu_torch.forward import calc_series\n"
        "from tsadar_tpu_torch.utils import artifacts, calibration, console, export, mlflow_shim, ncwriter, schema\n"
        "from tsadar_tpu_torch.utils.data_handling import hdf4, load_ts_data\n"
        "from tsadar_tpu_torch.utils.process import correct_throughput, evaluate_background, feature_detector, lineouts\n"
        "from tsadar_tpu_torch.utils.process import prepare, warpcorr\n"
        "from tsadar_tpu_torch.utils.plotting import edf_movie, lineout_plot, plotters\n"
        "from tsadar_tpu_torch.utils.data_handling import data_visualizer\n"
        f"print([m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN + AT_MODULE_LEVEL!r})])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_clean_env(), capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None legitimately resolves to it")
    cfg = {"parameters": {}, "other": {"extraoptions": {"spectype": "temporal"}}}
    angular = {"parameters": {}, "other": {"extraoptions": {"spectype": "angular_full"}, "ang_res_unit": 1},
               "optimizer": {"y_norm": False, "method": "adam"}, "data": {"lineouts": {"start": 0, "end": 1}}}
    arts_sas = {"sa": np.ones(3), "weights": np.ones((4, 3)), "angAxis": np.ones(4)}
    arts_data = {k: np.zeros((1, 1)) for k in ("e_data", "i_data", "e_amps", "i_amps", "noiseE", "noiseI")}
    for call in (
        lambda: port.ThomsonScatteringDiagnostic(angular, arts_sas),
        lambda: port.ThomsonParams.create({}, 1, batch=False),
        lambda: port.LossFunction(angular, arts_sas, {}),
        lambda: port.angular_optax(angular, arts_data, arts_sas),
        lambda: resolve_device(None),
        lambda: port.ThomsonScatteringDiagnostic(cfg, {"sa": np.ones(10), "weights": np.ones(10)}),
        lambda: port.ThomsonParams.create({}, 2),
        lambda: port.LossFunction({"optimizer": {"y_norm": False}, "data": {}, **cfg}, {"sa": np.ones(10), "weights": np.ones(10)}, {}),
        lambda: port.one_d_loop({"optimizer": {"method": "adam", "batch_size": 1, "y_norm": False}, "data": {}, **cfg},
                                {k: np.zeros((1, 1)) for k in ("e_data", "i_data", "e_amps", "i_amps", "noiseE", "noiseI")},
                                {"sa": np.ones(10), "weights": np.ones(10)}, np.arange(1), 1),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_the_port_covers_the_inverse_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"tsadar_tpu_torch/inverse/loss.py", "tsadar_tpu_torch/inverse/loops.py", "chip_smoke.py"} <= names


def test_the_port_covers_the_arts_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"tsadar_tpu_torch/ops/chi_bilinear.py", "tsadar_tpu_torch/core/params/spherical.py"} <= names
    assert (ROOT / "tsadar_tpu_torch" / "csrc" / "chi_bilinear.cu").is_file()
    from tsadar_tpu_torch.ops import build

    assert "chi_bilinear" in build.SOURCES and callable(port.angular_optax)


def test_the_port_covers_the_data_pipeline_and_the_last_kernels():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    pipeline = {f"tsadar_tpu_torch/utils/data_handling/{m}.py" for m in ("hdf4", "load_ts_data")} | {
        f"tsadar_tpu_torch/utils/process/{m}.py"
        for m in ("correct_throughput", "evaluate_background", "lineouts", "prepare", "warpcorr")
    }
    assert pipeline | {"tsadar_tpu_torch/ops/pv_tables.py", "tsadar_tpu_torch/inverse/fitter.py"} <= names
    assert (ROOT / "tsadar_tpu_torch" / "csrc" / "pv_tables.cu").is_file()
    from tsadar_tpu_torch.ops import build

    assert "pv_tables" in build.SOURCES


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, shutil.copy(ROOT / "chip_smoke.py", tmp_path))):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=_clean_env(), capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and out.stdout == ""
