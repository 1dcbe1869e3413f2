"""The device mesh: the port of adaptigraph_tpu/parallel/mesh.py over
torch.distributed: the 1-D data mesh (make_mesh, shard_batch, replicate)
and the 2-D data x model layout (make_mesh_2d, shard_params_model).

JAX runs one controller over every device, and XLA derives the
collectives (the gradient's psum, the population's reductions, the
activations' gathers of a column-parallel layer) from the arrays'
shardings. Here each rank is a process holding one device, the same
code and the same host draws; the caller starts the process group
(torch.distributed.init_process_group: nccl on the card, gloo on the
CPU). A sharded leaf is a plain tensor holding this rank's part, so a
model runs unchanged on it; the reductions that XLA inserts are written
out below (`gather`, `gather_rows`, `mean_over`, and the column-parallel
layer's pair of autograd functions). Each gathers with all_gather, never
all_reduce, and sums the parts in rank order, so a run repeats bit for
bit; each runs at every world size, 1 included.

On a 2-D (data, model) mesh the batch splits over `data` alone (every
rank of one data row holds the same rows), and the gradient and the
loss are averaged over the data sub-group alone: a column-parallel
weight's rows differ by model rank. `data` is always the mesh's first
dim.

Divergences by design: make_mesh(n) and make_mesh_2d(n_data, n_model)
span the whole world. JAX's take the first n (n_data * n_model) devices
and drop the rest silently; here a mesh larger or smaller than the world
raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

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


def _group_kind(what: str, device) -> str:
    """The device type of `device` (CUDA unless given), after checking
    that a process group runs and that its backend carries that device's
    tensors."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what} needs a process group: {_START}")
    kind = resolve_device(device).type
    backend = str(dist.get_backend()).lower()
    need = {"cuda": "nccl", "cpu": "gloo"}.get(kind)
    if need is None or need not in backend:
        raise RuntimeError(
            f"the process group's backend {backend!r} does not carry "
            f"{kind} tensors; {_START}")
    return kind


def _span_world(n: int) -> None:
    world = dist.get_world_size()
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices in a world of {world} processes: the "
            f"port's mesh spans the whole world (one process a device); "
            f"start {n} processes")


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device=None):
    """A 1-D DeviceMesh named (axis,) over the default process group's
    world, its device type that of `device` (CUDA unless given). Raises
    when no process group is initialised, when the group's backend cannot
    carry that device's tensors, and when n_devices is not the world's
    size."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = _group_kind("make_mesh", device)
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    _span_world(n)
    return init_device_mesh(kind, (n,), mesh_dim_names=(axis,))


def make_mesh_2d(n_data: int, n_model: int,
                 axes: tuple[str, str] = ("data", "model"), device=None):
    """A 2-D DeviceMesh (n_data, n_model) named `axes` over the world, the
    model axis varying fastest as in JAX's make_mesh_2d: rank r sits at
    (r // n_model, r % n_model). make_mesh's checks, n_data * n_model
    standing for its n_devices."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = _group_kind("make_mesh_2d", device)
    _span_world(int(n_data) * int(n_model))
    return init_device_mesh(kind, (int(n_data), int(n_model)),
                            mesh_dim_names=tuple(axes))


def check_data_mesh(mesh, axis: str | None = "data"):
    """Raise unless `mesh` is a DeviceMesh of one of the port's layouts: a
    1-D mesh whose dim is `axis`, or a 2-D mesh whose first dim is `axis`
    (the data axis; the second is the model axis); any names when axis
    is None. TypeError for anything else than a DeviceMesh,
    NotImplementedError for another shape or dim name."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh from make_mesh or "
                        f"make_mesh_2d, not {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if mesh.ndim not in (1, 2) or (axis is not None and names[:1] != (axis,)):
        raise NotImplementedError(
            f"mesh {names} of {mesh.ndim} dims: the port runs on a 1-D "
            f"({axis or 'data'!r},) mesh (make_mesh) or a 2-D "
            f"({axis or 'data'!r}, 'model') mesh (make_mesh_2d), the data "
            f"axis first")


def _map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def data_rank(mesh) -> int:
    """This rank's coordinate along the mesh's data axis (its first)."""
    return mesh.get_local_rank(0)


def local_rows(n_rows: int, mesh) -> slice | None:
    """This rank's rows of a leading dim of n_rows: a slice of n_rows /
    n_data rows by the data coordinate when the whole mesh's size divides
    n_rows (JAX's rule), None (the whole leaf, replicated) otherwise."""
    if n_rows % mesh.size():
        return None
    m = n_rows // mesh.size(0)
    r = data_rank(mesh)
    return slice(r * m, (r + 1) * m)


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's rows of every leaf (tensor or array) whose leading dim
    the mesh size divides, split over the data axis; every other leaf
    whole (JAX's replicate rule). Dicts, lists and tuples keep their
    structure."""
    check_data_mesh(mesh, axis)

    def put(x):
        if getattr(x, "ndim", 0) >= 1:
            rows = local_rows(x.shape[0], mesh)
            if rows is not None:
                return x[rows]
        return x

    return _map(put, batch)


def replicate(tree, mesh):
    """Every leaf as the mesh's first rank holds it: tensors and arrays
    are broadcast (a copy; the caller's leaf is left alone), other leaves
    by broadcast_object_list, from local rank 0 along each mesh dim in
    turn."""
    check_data_mesh(mesh, None)
    kind = mesh.device_type
    groups = [mesh.get_group(d) for d in range(mesh.ndim)]
    routes = [(g, dist.get_global_rank(g, 0)) for g in groups]

    def put(x):
        if torch.is_tensor(x):
            y = x.detach().clone().contiguous()
            home = y.device
            if y.device.type != kind:
                y = y.to(kind)
            for group, src in routes:
                dist.broadcast(y, src=src, group=group)
            return y.to(home)
        if hasattr(x, "__array__") and hasattr(x, "dtype"):
            return put(torch.as_tensor(x)).numpy()
        box = [x]
        for group, src in routes:
            dist.broadcast_object_list(box, src=src, group=group)
        return box[0]

    return _map(put, tree)


def barrier(mesh) -> None:
    """Every rank of the mesh waits for every other: a barrier along each
    mesh dim in turn."""
    for dim in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(dim))


def gather(x, mesh, mesh_dim: int = 0) -> list:
    """Every rank's `x` along mesh dim `mesh_dim` (the data axis unless
    given; equal shapes on every rank), in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(mesh_dim))]
    dist.all_gather(parts, x, group=mesh.get_group(mesh_dim))
    return parts


def _sum(parts):
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    return acc


def gather_rows(x, mesh):
    """The leading dim of every data rank's `x` joined in rank order: the
    whole population from each rank's rows."""
    return torch.cat(gather(x, mesh), dim=0)


def mean_over(x, mesh):
    """The mean of `x` over the mesh's data ranks, summed in rank order
    (the same bits on every rank and in every run)."""
    parts = gather(x, mesh)
    return _sum(parts) / len(parts)


# ------------------------------------------ the column-parallel layout


def axis_dim(mesh, axis: str) -> int:
    """The index of the mesh dim named `axis`; ValueError without one."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh {names} has no {axis!r} axis: the "
                         f"column-parallel layout needs a 2-D mesh from "
                         f"make_mesh_2d")
    return names.index(axis)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; backward, the input's gradient
    summed over the model ranks in rank order (each rank holds the part
    that flowed through its own output features)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(gather(g, ctx.mesh, ctx.dim)), None, None


class _GatherFeatures(torch.autograd.Function):
    """Megatron's g: forward, every model rank's output features joined in
    rank order along the last dim; backward, this rank's slice of the
    gradient (every model rank computes the same downstream, so the
    gradient is the same on each)."""

    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.rank, ctx.k = mesh.get_local_rank(dim), y.shape[-1]
        return torch.cat(gather(y, mesh, dim), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, k = ctx.rank, ctx.k
        return g[..., r * k:(r + 1) * k].contiguous(), None, None


class ColumnDense(nn.Module):
    """A column-parallel _Dense: weight (out / n_model, in) and bias
    (out / n_model,), this model rank's rows of the whole layer's; its
    output every model rank's features, joined in rank order. The input,
    weight and bias are cast to the compute dtype as _Dense casts them."""

    def __init__(self, dense, mesh, dim: int):
        super().__init__()
        k = dense.weight.shape[0] // mesh.size(dim)
        r = mesh.get_local_rank(dim)
        rows = slice(r * k, (r + 1) * k)
        self.weight = nn.Parameter(dense.weight.detach()[rows].clone())
        self.bias = nn.Parameter(dense.bias.detach()[rows].clone())
        self.mesh, self.dim = mesh, dim

    def forward(self, x):
        dt = x.dtype
        y = F.linear(_CopyToModel.apply(x, self.mesh, self.dim),
                     self.weight.to(dt), self.bias.to(dt))
        return _GatherFeatures.apply(y, self.mesh, self.dim)


def shard_params_model(model, mesh, axis: str = "model"):
    """JAX's tensor-parallel placement on `model` (a DynamicsPredictor;
    every parameter lives in a _Dense), in place: each _Dense whose output
    width the `axis` size divides becomes a ColumnDense holding this
    rank's rows (JAX's kernel (in, out) sharded P(None, axis), its bias
    P(axis)); every other layer keeps its whole, replicated weight. The
    parameter names stay the model's. Build the optimizer after this call,
    so that its state follows the local rows. Returns the model."""
    from adaptigraph_torch.dynamics.model import _Dense

    dim = axis_dim(mesh, axis)
    for name, layer in list(model.named_modules()):
        if isinstance(layer, _Dense) and \
                layer.weight.shape[0] % mesh.size(dim) == 0:
            parent, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(parent), leaf,
                    ColumnDense(layer, mesh, dim))
    return model


def gather_params_model(model, mesh):
    """The whole state_dict of a model after shard_params_model(model,
    mesh), on every rank, laid out as the unsharded model's: each
    ColumnDense's weight and bias gathered over its model axis and joined
    in rank order (what reading a sharded JAX array whole gives)."""
    out = model.state_dict()
    for name, layer in model.named_modules():
        if isinstance(layer, ColumnDense):
            for leaf in ("weight", "bias"):
                key = f"{name}.{leaf}"
                out[key] = torch.cat(gather(out[key], mesh, layer.dim), 0)
    return out
