"""Device selection and the f32 precision rule for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card. Raises when no card is present and the
    caller did not ask for the CPU explicitly — an entry point never falls
    back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def pin_full_f32() -> None:
    """Accuracy paths run f32 GEMMs in full f32: no TF32 anywhere (the
    PyTorch twin of the JAX package's "highest" matmul-precision rule)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
