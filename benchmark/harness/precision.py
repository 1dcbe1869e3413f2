"""The reference's products: full float32 (TF32 off) unless the control
asks for TF32, set on entry and restored on exit."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def matmul_precision(precision: str = "f32"):
    on = precision == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
