"""PyTorch/CUDA port of adaptigraph_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (engine, scenes, ops, dynamics, sim,
utils; as far as ported) and adds `kernels/`, the hand-written CUDA
sources that replace the Pallas TPU kernels. Entry points run on CUDA unless the caller passes
``device="cpu"``; without a GPU and without an explicit device they raise.
This package imports torch, numpy and the standard library only.
"""

from adaptigraph_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
