"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else CUDA.

    With no device given and no CUDA device present this raises rather than
    carrying on on the CPU: a CPU run must be asked for by name."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def full_f32_matmul():
    """Keep float32 matrix products in full float32 on the GPU (TF32 off),
    as the JAX package's products at Precision.HIGHEST and on the CPU are:
    without it a card's products cannot be held to the CPU's at 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
