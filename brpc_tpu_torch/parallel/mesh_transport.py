"""MeshTransport -- collectives over a ``torch.distributed`` device mesh.

Counterpart of ``brpc_tpu/parallel/mesh_transport.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims (``("dp",
"tp")``, ``("sp",)``, ``("pp",)``, ``("ici",)``), one process per rank,
and each named dim has its own process group.  The backend follows the
device: NCCL for a ``cuda`` mesh, gloo for a ``cpu`` one.  A collective
on a tensor that is not on the mesh's device raises: nothing is staged
through the host and no CUDA tensor goes through gloo.

**The per-rank rule.**  The JAX methods take a *global* array sharded
over the axis and return a global array.  The port runs one program per
rank, so its methods take the rank's *local* shard and return the local
result: rank r's result equals block r of the JAX result along the
sharded dim, or the whole of it where JAX replicates the result.

**Gradients.**  The collectives that sit on a differentiated path are
``torch.autograd.Function``\\ s whose backward is what ``jax.grad`` gives
for the JAX twin under ``shard_map(check_vma=False)`` (the tests hold
each against it):

- ``ring_shift(x, steps)``: the cotangent shifts ``-steps``;
- ``all_to_all(x, split, concat)``: the inverse exchange;
- ``all_gather``: each rank keeps its own block of the cotangent (the
  downstream computation is replicated, so every rank holds the whole
  cotangent);
- ``psum``: the cotangent passes through unchanged, for the same reason;
- ``reduce_scatter``: the cotangent is all-gathered.

Two more pairs serve the model code (Megatron-style tensor parallelism):
:func:`pvary` is the identity whose backward sums over the axis (the
partner of ``psum``: a replicated activation entering rank-local
compute), and :func:`all_gather_sum_grad` is an all-gather whose
backward reduce-scatters (for a gather whose consumers differ by rank).
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..butil.endpoint import EndPoint
from ..utils.device import resolve_device


def backend_for(device) -> str:
    """The process-group backend of a device type: NCCL for cuda, gloo
    for cpu."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _check_backend(device_type: str, group=None) -> None:
    have = dist.get_backend(group)
    want = backend_for(device_type)
    if want not in have:
        raise RuntimeError(
            f"a {device_type} mesh needs a {want} process group, this one "
            f"is {have!r}")


def _group_for(device) -> str:
    """The device type of ``device``, once the default process group is
    up with that type's backend."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.spmd.init_world first")
    _check_backend(dev.type)
    return dev.type


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device="cuda") -> DeviceMesh:
    """A mesh of ``shape`` over every rank of the default process group
    (which must be initialised, with the device's backend), dims named
    ``names``."""
    return init_device_mesh(_group_for(device), tuple(shape),
                            mesh_dim_names=tuple(names))


def default_mesh(axis_name: str = "ici", device="cuda") -> DeviceMesh:
    """1-D mesh over every rank -- the 'every chip is a peer' view."""
    return init_device_mesh(_group_for(device), (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


class Axis:
    """One named dim of a mesh as the per-rank code sees it: its process
    group, its size, this rank's index on it and the mesh's device."""

    def __init__(self, mesh: DeviceMesh, name: str):
        if name not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no axis {name!r} "
                             f"(axes {mesh.mesh_dim_names})")
        self.name = name
        self.group = mesh.get_group(name)
        self.size = mesh.size(mesh.mesh_dim_names.index(name))
        self.rank = mesh.get_local_rank(name)
        self.device_type = mesh.device_type
        self._peers = [dist.get_global_rank(self.group, i)
                       for i in range(self.size)]

    def peer(self, index: int) -> int:
        """The global rank of the axis's ``index``-th member."""
        return self._peers[index % self.size]

    def check(self, *ts: torch.Tensor) -> None:
        for t in ts:
            if t.device.type != self.device_type:
                raise ValueError(
                    f"axis {self.name!r} runs on {self.device_type}; a "
                    f"{t.device.type} tensor is not staged across")


def mesh_axis(mesh: Optional[DeviceMesh], name: Optional[str]
              ) -> Optional[Axis]:
    """``Axis(mesh, name)``, or None where the mesh lacks the axis."""
    if mesh is None or name is None or name not in (mesh.mesh_dim_names
                                                    or ()):
        return None
    return Axis(mesh, name)


# -- raw collectives on the local shard (no autograd) ------------------------

def _all_reduce(ax: Axis, x: torch.Tensor) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=ax.group)
    return out


def _all_gather(ax: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(ax.size)]
    dist.all_gather(parts, x.contiguous(), group=ax.group)
    return parts[0] if ax.size == 1 else torch.cat(parts, dim=dim)


def _reduce_scatter(ax: Axis, x: torch.Tensor, dim: int) -> torch.Tensor:
    if x.shape[dim] % ax.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {ax.size} ranks")
    parts = [c.contiguous() for c in x.chunk(ax.size, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=ax.group)
    return out


def _all_to_all(ax: Axis, x: torch.Tensor, split: int, concat: int
                ) -> torch.Tensor:
    if x.shape[split] % ax.size:
        raise ValueError(f"dim {split} of {tuple(x.shape)} does not split "
                         f"over {ax.size} ranks")
    send = [c.contiguous() for c in x.chunk(ax.size, dim=split)]
    recv = [torch.empty_like(c) for c in send]
    dist.all_to_all(recv, send, group=ax.group)
    return recv[0] if ax.size == 1 else torch.cat(recv, dim=concat)


def _ring_shift(ax: Axis, x: torch.Tensor, steps: int) -> torch.Tensor:
    if steps % ax.size == 0:            # every rank keeps its own block
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ax.peer(ax.rank + steps), ax.group),
           dist.P2POp(dist.irecv, out, ax.peer(ax.rank - steps), ax.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


# -- differentiable collectives ----------------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(ax, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.ax, g), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, sum_grad):
        ctx.ax, ctx.dim, ctx.sum_grad = ax, dim, sum_grad
        return _all_gather(ax, x, dim)

    @staticmethod
    def backward(ctx, g):
        ax, dim = ctx.ax, ctx.dim
        if ctx.sum_grad:
            return _reduce_scatter(ax, g, dim), None, None, None
        return g.chunk(ax.size, dim=dim)[ax.rank].contiguous(), None, None, \
            None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _reduce_scatter(ax, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.ax, g, ctx.dim), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, steps):
        ctx.ax, ctx.steps = ax, steps
        return _ring_shift(ax, x, steps)

    @staticmethod
    def backward(ctx, g):
        return _ring_shift(ctx.ax, g, -ctx.steps), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split, concat):
        ctx.ax, ctx.split, ctx.concat = ax, split, concat
        return _all_to_all(ax, x, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.ax, g, ctx.concat, ctx.split), None, None, \
            None


def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Sum over the axis, on every rank; backward passes through."""
    ax.check(x)
    return _Psum.apply(x, ax)


def pmean(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The mean over the axis, on every rank (``psum`` over its size)."""
    return psum(x, ax) / ax.size


def pvary(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The identity, whose backward sums the cotangent over the axis."""
    ax.check(x)
    return _Pvary.apply(x, ax)


def all_gather(x: torch.Tensor, ax: Axis, dim: int = 0) -> torch.Tensor:
    """Concatenation of every rank's ``x`` along ``dim``; the backward
    keeps this rank's block of the cotangent."""
    ax.check(x)
    return _AllGather.apply(x, ax, dim, False)


def all_gather_sum_grad(x: torch.Tensor, ax: Axis, dim: int = 0
                        ) -> torch.Tensor:
    """:func:`all_gather` whose backward reduce-scatters the cotangent
    (the transpose for consumers that differ by rank)."""
    ax.check(x)
    return _AllGather.apply(x, ax, dim, True)


def reduce_scatter(x: torch.Tensor, ax: Axis, dim: int = 0) -> torch.Tensor:
    """Block ``rank`` along ``dim`` of the sum over the axis."""
    ax.check(x)
    return _ReduceScatter.apply(x, ax, dim)


def ring_shift(x: torch.Tensor, ax: Axis, steps: int = 1) -> torch.Tensor:
    """Every rank passes ``x`` ``steps`` ranks down the ring: rank r's
    result is rank ``(r - steps) % n``'s input."""
    ax.check(x)
    return _RingShift.apply(x, ax, steps)


def all_to_all(x: torch.Tensor, ax: Axis, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Chunk j of ``x`` along ``split_axis`` goes to rank j; the chunks
    received are concatenated in rank order along ``concat_axis``."""
    ax.check(x)
    return _AllToAll.apply(x, ax, split_axis, concat_axis)


class MeshTransport:
    """Collective schedules over one mesh axis: the unit of addressing is
    the rank on the axis (EndPoint ``ici://mesh/i``), the unit of transfer
    a tensor shard.  Every method takes and returns this rank's local
    shard (see the module docstring)."""

    def __init__(self, mesh: Optional[DeviceMesh] = None, axis: str = "ici",
                 name: str = "mesh0", device="cuda"):
        self.mesh = mesh if mesh is not None else default_mesh(axis, device)
        names = self.mesh.mesh_dim_names
        self.axis = axis if axis in names else names[0]
        self.name = name
        self._ax = Axis(self.mesh, self.axis)
        self.device = torch.device(self.mesh.device_type)

    # -- addressing --------------------------------------------------------

    @property
    def n_peers(self) -> int:
        return int(self.mesh.size())

    @property
    def rank(self) -> int:
        """This process's index on the transport's axis."""
        return self._ax.rank

    def endpoint(self, index: int) -> EndPoint:
        return EndPoint(mesh=self.name, device_index=index)

    def endpoints(self) -> Sequence[EndPoint]:
        return [self.endpoint(i) for i in range(self.n_peers)]

    # -- residency ---------------------------------------------------------

    def scatter(self, array, axis: int = 0) -> torch.Tensor:
        """A host (or replicated) array -> this rank's block along
        ``axis``, on the mesh's device."""
        t = torch.as_tensor(np.asarray(array))
        n = self._ax.size
        if t.shape[axis] % n:
            raise ValueError(f"dim {axis} of {tuple(t.shape)} does not "
                             f"split over {n} ranks")
        return t.chunk(n, dim=axis)[self._ax.rank].contiguous().to(
            self.device)

    def replicate(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array)).to(self.device)

    def gather(self, x: torch.Tensor, axis: int = 0) -> np.ndarray:
        """Every rank's block along ``axis`` -> the whole array on the
        host."""
        self._ax.check(x)
        return _all_gather(self._ax, x.detach(), axis).cpu().numpy()

    # -- collectives ---------------------------------------------------------

    def ring_shift(self, x: torch.Tensor, steps: int = 1) -> torch.Tensor:
        """Every peer passes its shard ``steps`` neighbours down the ring
        (the streaming and pipeline primitive)."""
        return ring_shift(x, self._ax, steps)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Each peer ends with every shard, concatenated on dim 0."""
        return all_gather(x, self._ax, 0)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of all shards, on every peer."""
        return psum(x, self._ax)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """A (1, L) shard -> (1, L/n): peer i holds the i-th chunk of the
        element-wise sum of all shards."""
        return reduce_scatter(x, self._ax, x.dim() - 1)

    def all_to_all(self, x: torch.Tensor, split_axis: int = 1,
                   concat_axis: int = 0) -> torch.Tensor:
        """Transpose which dimension is sharded -- the re-partitioning
        move (and the Ulysses sequence<->head exchange)."""
        return all_to_all(x, self._ax, split_axis, concat_axis)


_lock = threading.Lock()
_default_transport: Optional[MeshTransport] = None


def global_mesh_transport(device="cuda") -> MeshTransport:
    """The process-wide transport over :func:`default_mesh`."""
    global _default_transport
    with _lock:
        if _default_transport is None:
            _default_transport = MeshTransport(device=device)
        return _default_transport
