"""The process mesh and its collectives.

PyTorch counterpart of the JAX package's `parallel/mesh.py`. There a mesh
is a 1-D `jax.sharding.Mesh` over devices and arrays carry shardings. Here
every rank is a process of its own (SPMD, one device each), so a `Mesh`
is this process's view of the group: the process group, its rank, the
world size and its device. `obs_sharding` takes this rank's slice of a
leading (observation or edge) axis; `replicated` keeps a tensor whole.

`all_reduce` is the one collective the solvers use (JAX's `psum`): a sum
over the ranks of `group`, in place, or the identity when `group` is None
(one process). It counts its calls and bytes (`ALL_REDUCES`,
`ALL_REDUCE_BYTES`) and, inside `recording()`, the shape of each call.
`all_reduce_many` sums several independent tensors in one call over their
flat concatenation, as XLA's all-reduce combiner merges the independent
`psum`s of one program.

`capturable(group)` says whether a solve with this group can run as a
captured program (utils/programs.py): with no group, or with an NCCL
group, whose collectives are kernels on the card that a CUDA graph
records. gloo stages every collective through the host, which a graph
cannot hold, so its solves run their eager bodies.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

OBS_AXIS = "obs"   # the JAX package's name of the mesh's one axis

ALL_REDUCES = 0
ALL_REDUCE_BYTES = 0
_recorders: list = []


class Mesh(NamedTuple):
    """This rank's view of a 1-D mesh of `size` ranks."""

    group: Optional[object]   # the process group; None for one process
    rank: int
    size: int
    device: torch.device


def make_mesh(num_devices: Optional[int] = None, device=None, group=None) -> Mesh:
    """The mesh of this process: the ranks of `group` (the default group
    when torch.distributed is initialized and `group` is None), or a
    one-process mesh with no group when it is not. `num_devices`, when
    given, must equal the group's size. `device` defaults to the card
    cuda:<rank modulo the visible cards>; the CPU runs only when asked."""
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    elif group is not None:
        raise ValueError("a process group was given but torch.distributed is not initialized")
    else:
        rank, size = 0, 1
    if num_devices is not None and num_devices != size:
        raise ValueError(f"asked for a mesh of {num_devices} ranks, the group has {size}")
    if device is None:
        device = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return Mesh(group, rank, size, torch.device(device))


def shard_bounds(n: int, size: int, rank: int):
    """[lo, hi) of rank's contiguous share of n items, the first n % size
    ranks one longer."""
    base, extra = divmod(n, size)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


def obs_sharding(mesh: Mesh, x):
    """This rank's 1/size slice of the leading axis of x (a tensor or an
    array), which must divide evenly, on the mesh's device."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} does not split over {mesh.size} ranks")
    k = n // mesh.size
    return torch.as_tensor(x[mesh.rank * k:(mesh.rank + 1) * k], device=mesh.device)


def replicated(mesh: Mesh, x):
    """x whole, on the mesh's device (every rank holds the same values)."""
    return torch.as_tensor(x, device=mesh.device)


def all_reduce(x, group=None):
    """Sum x over the ranks of `group` in place and return it; x itself
    when `group` is None. Counted in ALL_REDUCES / ALL_REDUCE_BYTES."""
    if group is None:
        return x
    dist.all_reduce(x, group=group)
    _count(x)
    return x


def _count(x):
    """One all_reduce of x: its call, its bytes and, in every recorder, its
    shape."""
    global ALL_REDUCES, ALL_REDUCE_BYTES
    ALL_REDUCES += 1
    ALL_REDUCE_BYTES += x.numel() * x.element_size()
    for rec in _recorders:
        rec.append(tuple(x.shape))


def all_reduce_many(tensors, group=None):
    """Sum each of `tensors` (one dtype) over the ranks of `group` with ONE
    all_reduce of their flat concatenation; returns the sums as views of
    that buffer, in order and in their shapes. With `group` None the
    inputs come back untouched (no concatenation). Counted as one call of
    the buffer's bytes, one shape in `recording()`."""
    tensors = list(tensors)
    if group is None:
        return tensors
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].view(t.shape))
        lo += t.numel()
    return out


def capturable(group) -> bool:
    """True when a solve over `group` can be captured: no group (one
    process) or an NCCL group; False for any other backend (gloo)."""
    return group is None or dist.get_backend(group) == "nccl"


@contextlib.contextmanager
def recording():
    """Yields a list that collects the shape of every all_reduce made
    inside the block."""
    rec: list = []
    _recorders.append(rec)
    try:
        yield rec
    finally:
        _recorders.remove(rec)


@contextlib.contextmanager
def captured():
    """For a capture, which runs nothing: yields the list of the shapes of
    the all_reduces recorded inside the block, and takes them back from
    every recorder that was open before it."""
    outer = [(rec, len(rec)) for rec in _recorders]
    try:
        with recording() as rec:
            yield rec
    finally:
        for r, n in outer:
            del r[n:]


def replayed(shapes):
    """Record `shapes` (a capture's, see `captured`) in every open recorder,
    as a replay of that capture would have made them."""
    for rec in _recorders:
        rec.extend(shapes)
