"""Padding a sample-batched population to a multiple of its chunk."""

from __future__ import annotations

import torch


def pad_samples(x, pad: int):
    """x with its first sample repeated `pad` times at the end (a population
    padded to a multiple of its chunk)."""
    if not pad:
        return x
    return torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))], dim=0)
