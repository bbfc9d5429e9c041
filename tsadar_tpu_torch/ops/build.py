"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  Libraries land in
``tsadar_tpu_torch/_build/`` (git-ignored) under a name that carries the hash
of the source, the shared headers and the flags, so an edited source is
rebuilt at its next use.
Nothing is compiled at import: ``build()`` runs at first use, or up front from
a driver that wants the build timed as set-up.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("lin_lookup", "cubic_lookup", "spectrum_tail", "spectrum_tail_bwd", "chi_bilinear", "pv_tables")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's kernels cannot be built")


def library_path(name):
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES):
    """Compile every listed kernel whose library is missing; one nvcc each, all at once.

    Returns {name: compiler output} of every listed kernel whose output is kept
    beside its library (``.log``): ptxas reports each kernel's registers,
    stack and spills.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    jobs, logs = [], {}
    for name in names:
        src, so = library_path(name)
        if so.exists():
            if so.with_suffix(".log").exists():
                logs[name] = so.with_suffix(".log").read_text()
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((name, so, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
        else:
            so.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.cache
def library(name):
    build((name,))
    return ctypes.CDLL(str(library_path(name)[1]))


@functools.cache
def c_function(lib_name, fn_name, argtypes):
    """The C entry point ``fn_name`` of a kernel library, with its argument types set."""
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_input(t, name, ndim):
    """A kernel operand must be a contiguous float32 CUDA tensor of rank ``ndim``.

    The raw wrappers record nothing for autograd: gradients flow through the
    ``torch.autograd.Function`` beside each wrapper, whose forward and backward
    run with gradient mode off.  Called directly on a tensor that is being
    differentiated, a wrapper would drop the gradient without a word, so that
    is refused.
    """
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and t.requires_grad:
        raise ValueError(f"{name} requires grad: call the kernel through its autograd Function, not its raw wrapper")


def launch(fn, *args, device):
    """Run a C launcher on the current stream of ``device``; raise on a CUDA error."""
    with torch.cuda.device(device):
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err:
        raise RuntimeError(f"{fn.__name__} failed with CUDA error {err}")


def on_card(*tensors):
    """True for CUDA tensors (the kernel path), False for CPU tensors (the plain path)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"operands must all lie on the CPU or all on a CUDA device, got {sorted(kinds)}")
