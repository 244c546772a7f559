"""The collectives a sharded strategy issues over a mesh's subgroups.

The JAX package has no counterpart: GSPMD emits its collectives from the
shardings. The port places the shards itself (``executor.py``) and runs
these over the default ``torch.distributed`` group, rank r at the mesh
position of JAX's device r (``machine.Mesh.coords``).

``MeshComm`` builds, once per mesh and on every rank in one order, a
process group for every set of axes above 1 (the ranks that share the
other coordinates). A dim sharded over a tuple of axes is split into
blocks in the tuple's order, the first axis the most significant, as a
``PartitionSpec`` entry reads; torch orders a group's members by global
rank, so each collective places blocks by ``Mesh.block_index``.

Four collectives (sum reductions): all-reduce, all-gather along a dim,
reduce-scatter along a dim and all-to-all (one dim's sharding moved to
another). Reduce-scatter also has an asynchronous form
(``async_op=True``): the call is issued and returns a ``Pending`` whose
``wait()`` gives the result: the executor's weight-update sharding
issues its gradient reduce-scatters while the backward still runs.
``record`` keeps each call's kind, axes and output bytes; the executor
starts a fresh list each step (``begin_step``) and the last step's is
``step_record``, the census ``obs/inspect.py`` reads.

Transport: each call hands its tensor to the group's backend as it is:
NCCL for CUDA tensors, gloo for CPU tensors, or gloo with CUDA tensors
when the caller named gloo for ranks that share one card. Gloo takes
CUDA tensors, f32 and bf16, for every collective used here (all-reduce,
all-gather, reduce-scatter, all-to-all; ``chip_smoke.py``'s ``[mesh]``
checks each by value on the card) and copies them through host memory
itself, so nothing here stages a tensor or retries another way.

Autograd. A value replicated over an axis is the same on every rank of
it, and so is its gradient: each rank holds the whole gradient of a
replicated value and its own block of the gradient of a sharded one.
Every differentiable collective keeps that invariant:

- ``all_reduce`` (partial sums -> replicated): backward identity;
- ``copy_to`` (a replicated value entering a computation that differs
  by rank over the axes, Megatron's "f"): forward identity, backward
  all-reduce;
- ``all_gather`` (sharded -> replicated): backward the rank's own block;
- ``slice_to`` (replicated -> sharded): backward all-gather;
- ``reduce_scatter`` (partial sums -> sharded): backward all-gather;
- ``all_to_all``: backward the inverse all-to-all.

A parameter replicated over an axis its op's batch is split over gets a
partial gradient on each rank: the executor all-reduces it over those
axes after the backward (``OpNode.grad_axes``).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

AxisTuple = Tuple[str, ...]
NormSpec = Tuple[AxisTuple, ...]


def norm_spec(spec, ndim: int, mesh) -> NormSpec:
    """A spec (None, or a tuple of None / axis / tuple of axes) as one
    tuple of axis names per dim, ``ndim`` long, without the axes of size
    1 (they split nothing)."""
    sizes = dict(mesh.shape) if mesh is not None else {}
    entries = list(spec) if spec is not None else []
    entries = (entries + [None] * ndim)[:ndim]
    out = []
    for e in entries:
        axes = () if e is None else (tuple(e) if isinstance(e, (tuple, list))
                                     else (e,))
        out.append(tuple(a for a in axes if a is not None
                         and sizes.get(a, 1) > 1))
    return tuple(out)


def replicated(ndim: int) -> NormSpec:
    return ((),) * ndim


def spec_axes(spec: NormSpec) -> AxisTuple:
    return tuple(a for e in spec for a in e)


class Pending:
    """An issued asynchronous collective: ``wait()`` blocks until it has
    completed (on a CUDA tensor: the current stream waits for it) and
    returns its result. The work and its buffers are held until then;
    with no work (a collective over no axis) the result is already
    there."""

    def __init__(self, work, out: torch.Tensor, *buffers):
        self._work, self._out, self._buffers = work, out, buffers

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = self._buffers = None
        return self._out


class MeshComm:
    """The collectives of ``mesh`` over the default process group (one
    rank a mesh position). Constructed collectively: every rank makes
    the same subgroups in the same order."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.dist = dist
        self.mesh = mesh
        self.rank = dist.get_rank()
        world = dist.get_world_size()
        if world != mesh.size:
            raise ValueError(f"mesh {mesh.shape} has {mesh.size} positions; "
                             f"the process group has {world} ranks")
        self.backend = str(dist.get_backend())
        big = [a for a in mesh.axis_names if mesh.shape[a] > 1]
        # {frozenset(axes): (group, members ascending)} of this rank
        self._groups: Dict[frozenset, Tuple[object, Tuple[int, ...]]] = {}
        for k in range(1, len(big) + 1):
            for subset in itertools.combinations(big, k):
                if k == len(big):
                    # every rank: the default group, ranks in order
                    self._groups[frozenset(subset)] = (
                        dist.group.WORLD, tuple(range(world)))
                    continue
                classes = sorted({mesh.members(subset, r)
                                  for r in range(world)})
                for members in classes:
                    g = dist.new_group(list(members))
                    if self.rank in members:
                        self._groups[frozenset(subset)] = (g, members)
        self.record: List[Tuple[str, AxisTuple, int]] = []
        self.step_record: List[Tuple[str, AxisTuple, int]] = []

    # ---- bookkeeping ------------------------------------------------------
    def begin_step(self) -> None:
        """Start a train step's record."""
        self.record = []

    def end_step(self) -> None:
        """The step's record becomes ``step_record``."""
        self.step_record, self.record = self.record, []

    def census(self, record=None) -> Dict[str, Dict[str, float]]:
        """{kind: {count, bytes}} of a record (default the last step's),
        in the census vocabulary of ``obs/inspect.py``."""
        out: Dict[str, Dict[str, float]] = {}
        for kind, _axes, nbytes in (self.step_record if record is None
                                    else record):
            e = out.setdefault(kind, dict(count=0, bytes=0.0))
            e["count"] += 1
            e["bytes"] += float(nbytes)
        return out

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def block(self, axes: Sequence[str]) -> int:
        """This rank's block index along a dim split over ``axes``."""
        return self.mesh.block_index(axes, self.rank)

    def _group(self, axes: Sequence[str]):
        return self._groups[frozenset(axes)]

    def _note(self, kind: str, axes, t: torch.Tensor) -> None:
        self.record.append((kind, tuple(axes),
                            int(t.numel() * t.element_size())))

    # ---- the collectives (no autograd) -------------------------------------
    def all_reduce(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axes`` (a new tensor)."""
        axes = tuple(axes)
        if not axes:
            return t
        group, _ = self._group(axes)
        out = t.clone(memory_format=torch.contiguous_format)
        self.dist.all_reduce(out, group=group)
        self._note("all-reduce", axes, out)
        return out

    def all_gather(self, t: torch.Tensor, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
        """The blocks of ``t`` of every rank of ``axes`` joined along
        ``dim`` in block order."""
        axes = tuple(axes)
        if not axes:
            return t
        group, members = self._group(axes)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in members]
        self.dist.all_gather(parts, t, group=group)
        order = [self.mesh.block_index(axes, m) for m in members]
        blocks = [None] * len(members)
        for i, b in enumerate(order):
            blocks[b] = parts[i]
        out = torch.cat(blocks, dim=dim)
        self._note("all-gather", axes, out)
        return out

    def own_block(self, t: torch.Tensor, axes: Sequence[str],
                  dim: int) -> torch.Tensor:
        """This rank's block of ``t`` split along ``dim`` over ``axes``
        (no communication)."""
        axes = tuple(axes)
        if not axes:
            return t
        n = self.size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"split over {axes} ({n} blocks)")
        return t.chunk(n, dim=dim)[self.block(axes)].contiguous()

    def reduce_scatter(self, t: torch.Tensor, axes: Sequence[str], dim: int,
                       async_op: bool = False):
        """This rank's block, along ``dim``, of the sum of ``t`` over the
        ranks of ``axes``; with ``async_op`` a ``Pending`` of it."""
        axes = tuple(axes)
        if not axes:
            return Pending(None, t) if async_op else t
        n = self.size(axes)
        if t.shape[dim] % n:
            raise ValueError(f"reduce-scatter: dim {dim} of size "
                             f"{t.shape[dim]} does not split over {n}")
        group, members = self._group(axes)
        chunks = t.chunk(n, dim=dim)
        # the input's i-th slab along dim 0 goes to group rank i
        ins = torch.cat([chunks[self.mesh.block_index(axes, m)].contiguous()
                         for m in members], dim=0)
        out = torch.empty_like(chunks[0], memory_format=torch.contiguous_format)
        work = _REDUCE_SCATTER(out, ins, group=group, async_op=async_op)
        self._note("reduce-scatter", axes, out)
        return Pending(work, out, ins) if async_op else out

    def all_to_all(self, t: torch.Tensor, axes: Sequence[str],
                   split_dim: int, concat_dim: int) -> torch.Tensor:
        """Split ``t`` along ``split_dim`` into one block a rank of
        ``axes`` (block j to the rank at block index j) and join what
        arrives along ``concat_dim`` in block order: the sharding over
        ``axes`` moves from ``concat_dim`` to ``split_dim``."""
        axes = tuple(axes)
        if not axes:
            return t
        n = self.size(axes)
        group, members = self._group(axes)
        chunks = t.chunk(n, dim=split_dim)
        # all_to_all_single sends the i-th slab of dim 0 to group rank i
        send = torch.stack([chunks[self.mesh.block_index(axes, m)]
                            .contiguous() for m in members])
        recv = torch.empty_like(send)
        self.dist.all_to_all_single(recv, send, group=group)
        blocks = [None] * n
        for i, m in enumerate(members):
            blocks[self.mesh.block_index(axes, m)] = recv[i]
        out = torch.cat(blocks, dim=concat_dim)
        self._note("all-to-all", axes, out)
        return out

    def gather_whole(self, t: torch.Tensor, spec: NormSpec) -> torch.Tensor:
        """The whole tensor on every rank from each rank's box under
        ``spec`` (no autograd)."""
        for d, axes in enumerate(spec):
            t = self.all_gather(t, axes, d)
        return t

    # ---- differentiable forms ---------------------------------------------
    def reduce(self, x, axes):
        """``all_reduce`` with autograd (backward identity)."""
        return _AllReduce.apply(x, self, tuple(axes)) if axes else x

    def copy_to(self, x, axes):
        """Identity forward, all-reduce backward."""
        return _CopyTo.apply(x, self, tuple(axes)) if axes else x

    def gather(self, x, axes, dim):
        """``all_gather`` with autograd (backward: own block)."""
        return _AllGather.apply(x, self, tuple(axes), dim) if axes else x

    def scatter(self, x, axes, dim):
        """This rank's block with autograd (backward: all-gather)."""
        return _SliceTo.apply(x, self, tuple(axes), dim) if axes else x

    def reduce_scatter_grad(self, x, axes, dim):
        """``reduce_scatter`` with autograd (backward: all-gather)."""
        return (_ReduceScatter.apply(x, self, tuple(axes), dim) if axes
                else x)

    def all_to_all_grad(self, x, axes, split_dim, concat_dim):
        """``all_to_all`` with autograd (backward: the inverse)."""
        return (_AllToAll.apply(x, self, tuple(axes), split_dim, concat_dim)
                if axes else x)

    def reshard(self, x: torch.Tensor, src: NormSpec,
                dst: NormSpec) -> torch.Tensor:
        """``x``, this rank's box under ``src``, as its box under ``dst``
        (differentiable). One axis moving between two dims is one
        all-to-all; otherwise a dim whose ``src`` axes are not a prefix of
        its ``dst`` axes is gathered whole, then every dim takes its own
        block of the axes ``dst`` adds."""
        src, dst = tuple(src), tuple(dst)
        if src == dst:
            return x
        diff = [d for d in range(len(src)) if src[d] != dst[d]]
        if len(diff) == 2:
            i, j = diff
            for a, b in ((i, j), (j, i)):
                if (src[a] and not dst[a] and not src[b]
                        and dst[b] == src[a]):
                    # the sharding moves from dim a to dim b
                    return self.all_to_all_grad(x, src[a], b, a)
        cur = list(src)
        for d in range(len(cur)):
            if cur[d] != dst[d][:len(cur[d])]:
                x = self.gather(x, cur[d], d)
                cur[d] = ()
        # an axis dst adds on a dim must be free on every other dim
        while True:
            adds = {a: d for d in range(len(cur))
                    for a in dst[d][len(cur[d]):]}
            clash = [d for d in range(len(cur)) for a in cur[d]
                     if a in adds and adds[a] != d]
            if not clash:
                break
            d = clash[0]
            x = self.gather(x, cur[d], d)
            cur[d] = ()
        for d in range(len(cur)):
            extra = dst[d][len(cur[d]):]
            if extra:
                x = self.scatter(x, extra, d)
        return x


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        return comm.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous(), ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.comm, ctx.axes, ctx.dim = comm, axes, dim
        return comm.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.own_block(g, ctx.axes, ctx.dim), None, None, None


class _SliceTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.comm, ctx.axes, ctx.dim = comm, axes, dim
        return comm.own_block(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm.all_gather(g.contiguous(), ctx.axes, ctx.dim), None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.comm, ctx.axes, ctx.dim = comm, axes, dim
        return comm.reduce_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm.all_gather(g.contiguous(), ctx.axes, ctx.dim), None,
                None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, split_dim, concat_dim):
        ctx.comm, ctx.axes = comm, axes
        ctx.split_dim, ctx.concat_dim = split_dim, concat_dim
        return comm.all_to_all(x, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.comm.all_to_all(g.contiguous(), ctx.axes, ctx.concat_dim,
                                    ctx.split_dim),
                None, None, None, None)


def _reduce_scatter_fn():
    import torch.distributed as dist
    # PyTorch 2.13 renames reduce_scatter_tensor (2.11 has only the old
    # name)
    return getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor


_REDUCE_SCATTER = _reduce_scatter_fn()

_COMMS: Dict[Tuple, MeshComm] = {}


def mesh_comm(mesh) -> Optional[MeshComm]:
    """The ``MeshComm`` of ``mesh`` in this process's group, made at its
    first use (collectively: every rank asks in the same order); None
    without a group of more than one rank or for a mesh of one
    position."""
    import torch.distributed as dist

    if (mesh is None or mesh.size <= 1 or not dist.is_available()
            or not dist.is_initialized() or dist.get_world_size() <= 1):
        return None
    key = (id(dist.group.WORLD), tuple(mesh.shape.items()))
    comm = _COMMS.get(key)
    if comm is None:
        comm = _COMMS[key] = MeshComm(mesh)
    return comm
