"""tsadar_tpu_torch: the Thomson-scattering forward model in PyTorch, for CUDA GPUs.

A port of ``tsadar_tpu`` (JAX on a TPU) that imports nothing of it: plain
tensor code in PyTorch, and every TPU kernel on the ported path rewritten by
hand in CUDA C++ for Hopper (``csrc/``, built by nvcc at first use).  Entry
points run on the GPU unless the caller asks for ``device="cpu"``, where the
plain PyTorch forms of the kernels run in float64.
"""

from .core.diagnostic import ThomsonScatteringDiagnostic
from .core.params import ThomsonParams
from .device import resolve_device, working_dtype
from .utils.calibration import get_scattering_angles

__all__ = [
    "ThomsonScatteringDiagnostic",
    "ThomsonParams",
    "get_scattering_angles",
    "resolve_device",
    "working_dtype",
]
