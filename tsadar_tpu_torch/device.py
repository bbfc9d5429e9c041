"""Device and dtype policy of the port.

Entry points run on the GPU unless the caller asks for the CPU: ``device=None``
means ``cuda``, and with no GPU present that is an error that names
``device="cpu"`` -- the port never picks the CPU by itself.  Working dtypes are
float32 on the card (as on the TPU) and float64 on the CPU, where the parity
tests hold the port against the JAX package.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on (``None`` means ``cuda``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tsadar_tpu_torch runs on a CUDA device unless told otherwise, and none is "
                "available; pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        # Full-f32 matmuls, set explicitly: the 2V path's PV pole tables are f32
        # products against a precombined f64-built matrix, and reduced matmul
        # precision (TF32 keeps ~3 decimal digits) wrecks them -- the JAX
        # diagnostic forces "highest" precision for the same reason.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device


def working_dtype(device: torch.device) -> torch.dtype:
    """float32 on the card, float64 on the CPU."""
    return torch.float32 if device.type == "cuda" else torch.float64
