"""The 1-D data mesh: the port of adaptigraph_tpu/parallel/mesh.py's
make_mesh, shard_batch and replicate, over torch.distributed.

JAX runs one controller over every device, and XLA derives the
collectives (the gradient's psum, the population's reductions) from the
arrays' shardings. Here each rank is a process holding one device, the
same code and the same host draws; the caller starts the process group
(torch.distributed.init_process_group: nccl on the card, gloo on the
CPU). A sharded leaf is a plain tensor holding this rank's rows, so a
model runs unchanged on them; the reductions that XLA inserts are
written out below (`gather`, `gather_rows`, `mean_over`). Each gathers
with all_gather, never all_reduce, and `mean_over` sums the parts in rank
order, so a run repeats bit for bit; each runs at every world size, 1
included.

Divergence by design: make_mesh(n) spans the whole world. JAX's
make_mesh takes the first n devices and drops the rest silently; here a
mesh larger or smaller than the world raises.

Not ported yet: make_mesh_2d and shard_params_model (the 2-D data x
model layout, column-parallel weights); `check_data_mesh` refuses a 2-D
mesh.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from adaptigraph_torch.utils.device import resolve_device

_START = ("start one first: torch.distributed.init_process_group(backend, "
          "init_method=..., rank=..., world_size=...), nccl for CUDA "
          "tensors, gloo for CPU ones")


def world_size() -> int:
    """The default process group's size; 1 when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_from_env(device=None):
    """Start the default process group from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the
    card) when WORLD_SIZE is above 1 and no group is running: nccl for
    CUDA (`device` unless given), gloo for the CPU. Does nothing
    otherwise."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return
    kind = resolve_device(device).type
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method="env://")


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device=None):
    """A 1-D DeviceMesh named (axis,) over the default process group's
    world, its device type that of `device` (CUDA unless given). Raises
    when no process group is initialised, when the group's backend cannot
    carry that device's tensors, and when n_devices is not the world's
    size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"make_mesh needs a process group: {_START}")
    kind = resolve_device(device).type
    backend = str(dist.get_backend()).lower()
    need = {"cuda": "nccl", "cpu": "gloo"}.get(kind)
    if need is None or need not in backend:
        raise RuntimeError(
            f"the process group's backend {backend!r} does not carry "
            f"{kind} tensors; {_START}")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices in a world of {world} processes: the "
            f"port's mesh spans the whole world (one process a device); "
            f"start {n} processes")
    return init_device_mesh(kind, (n,), mesh_dim_names=(axis,))


def check_data_mesh(mesh, axis: str | None = "data"):
    """Raise unless `mesh` is a 1-D DeviceMesh whose one dim is `axis`
    (any name when axis is None): TypeError for anything else than a
    DeviceMesh, NotImplementedError for a 2-D mesh or another dim name."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh from make_mesh, not "
                        f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if mesh.ndim != 1 or (axis is not None and names != (axis,)):
        raise NotImplementedError(
            f"mesh {names} of {mesh.ndim} dims: the port runs on a 1-D "
            f"({axis or 'data'!r},) mesh; the 2-D data x model "
            f"layout (make_mesh_2d, shard_params_model) is the next slice "
            f"of the port")


def _map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def local_rows(n_rows: int, mesh) -> slice | None:
    """This rank's rows of a leading dim of n_rows: a slice when the mesh
    size divides it, None (the whole leaf, replicated) otherwise."""
    n = mesh.size()
    if n_rows % n:
        return None
    m = n_rows // n
    r = mesh.get_local_rank()
    return slice(r * m, (r + 1) * m)


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's rows of every leaf (tensor or array) whose leading dim
    the mesh size divides; every other leaf whole (JAX's replicate
    rule). Dicts, lists and tuples keep their structure."""
    check_data_mesh(mesh, axis)

    def put(x):
        if getattr(x, "ndim", 0) >= 1:
            rows = local_rows(x.shape[0], mesh)
            if rows is not None:
                return x[rows]
        return x

    return _map(put, batch)


def replicate(tree, mesh):
    """Every leaf as rank 0 of the mesh holds it: tensors and arrays are
    broadcast (a copy; the caller's leaf is left alone), other leaves by
    broadcast_object_list."""
    check_data_mesh(mesh, None)
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)
    kind = mesh.device_type

    def put(x):
        if torch.is_tensor(x):
            y = x.detach().clone().contiguous()
            home = y.device
            if y.device.type != kind:
                y = y.to(kind)
            dist.broadcast(y, src=src, group=group)
            return y.to(home)
        if hasattr(x, "__array__") and hasattr(x, "dtype"):
            return put(torch.as_tensor(x)).numpy()
        box = [x]
        dist.broadcast_object_list(box, src=src, group=group)
        return box[0]

    return _map(put, tree)


def gather(x, mesh) -> list:
    """Every rank's `x` (equal shapes on every rank), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size())]
    dist.all_gather(parts, x, group=mesh.get_group())
    return parts


def gather_rows(x, mesh):
    """The leading dim of every rank's `x` joined in rank order: the
    whole population from each rank's rows."""
    return torch.cat(gather(x, mesh), dim=0)


def mean_over(x, mesh):
    """The mean of `x` over the mesh's ranks, summed in rank order (the
    same bits on every rank and in every run)."""
    parts = gather(x, mesh)
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc / len(parts)
