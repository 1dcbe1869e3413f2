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
