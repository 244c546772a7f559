"""Parallel (resharding) operators: first-class PCG nodes.

PyTorch counterpart of ``flexflow_tpu/ops/parallel_ops.py``
(``src/parallel_ops/{partition,combine,replicate,reduction,
fused_parallel_op}.cc`` in the reference). Each op's value is what the
JAX package computes: the identity, or for ``Reduction`` (and a
``FusedParallelOp`` holding one) the sum of the replica groups laid out
along a dim. Each op rewrites its input's spec entries
(``preferred_spec_update``), and ``parallel/strategy.py`` records the
result as the op's output spec. On one device that is all; over a
process group the executor reshards the input to that spec
(``parallel/comm.py``), which issues what the spec demands: a slice
(``Repartition``), an all-gather (``Combine``), a gather to every rank
(``Replicate``), and for ``Reduction`` the group sum on each rank's rows
of the whole dim.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op


def _group_sum(x: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    d = dim % x.dim()
    shape = x.shape[:d] + (k, x.shape[d] // k) + x.shape[d + 1:]
    return torch.sum(x.reshape(shape), dim=d)


class ParallelOpBase(Op):
    """Identity compute; the layout comes from the strategy."""

    is_parallel_op = True
    # the executor's sharded rule: input resharded to the output's spec
    shard_rule = "elementwise"

    def flops(self):
        return 0

    def output_dim_roles(self):
        return [tuple(DimRole.SAMPLE if i == 0 else DimRole.OTHER
                      for i in range(len(s)))
                for s in self.output_shapes]


@register_op(OperatorType.REPARTITION)
class Repartition(ParallelOpBase):
    """Split dim ``repartition_dim`` into ``repartition_degree`` shards
    over the mesh axis ``axis``."""

    def __init__(self, layer, input_shapes):
        self.repartition_dim = layer.get_property("dim", 0)
        self.repartition_degree = layer.get_property("degree", 1)
        self.axis = layer.get_property("axis", None)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        shp = self.input_shapes[0]
        d = self.repartition_dim % len(shp)
        if shp[d] % self.repartition_degree:
            raise ValueError(
                f"repartition: dim {d} size {shp[d]} not divisible by "
                f"{self.repartition_degree}")
        return [tuple(shp)]

    def forward(self, params, inputs, ctx: OpContext):
        return [inputs[0]]

    def preferred_spec_update(self, entries):
        d = self.repartition_dim % len(self.output_shapes[0])
        entries = list(entries)
        # the repartition owns its axis: another dim sharded on it
        # un-shards here
        for i, e in enumerate(entries):
            axes = e if isinstance(e, tuple) else (e,)
            if i != d and self.axis in axes:
                entries[i] = (tuple(a for a in axes if a != self.axis)
                              or None) if isinstance(e, tuple) else None
        entries[d] = self.axis
        return entries


@register_op(OperatorType.COMBINE)
class Combine(ParallelOpBase):
    """Gather the shards of dim ``combine_dim``: the all-gather boundary."""

    def __init__(self, layer, input_shapes):
        self.combine_dim = layer.get_property("dim", 0)
        self.combine_degree = layer.get_property("degree", 1)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [tuple(self.input_shapes[0])]

    def forward(self, params, inputs, ctx: OpContext):
        return [inputs[0]]

    def preferred_spec_update(self, entries):
        entries = list(entries)
        entries[self.combine_dim % len(self.output_shapes[0])] = None
        return entries


@register_op(OperatorType.REPLICATE)
class Replicate(ParallelOpBase):
    """Broadcast to ``replicate_degree`` replicas: the output is fully
    replicated."""

    def __init__(self, layer, input_shapes):
        self.replicate_degree = layer.get_property("degree", 1)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [tuple(self.input_shapes[0])]

    def forward(self, params, inputs, ctx: OpContext):
        return [inputs[0]]

    def preferred_spec_update(self, entries):
        return [None] * len(entries)


@register_op(OperatorType.REDUCTION)
class Reduction(ParallelOpBase):
    """Sum ``reduction_degree`` partial replicas laid out along dim
    ``reduction_dim``: input (..., k*d, ...) sums its k groups of d."""

    shard_rule = "per_sample"

    def __init__(self, layer, input_shapes):
        self.reduction_dim = layer.get_property("dim", 0)
        self.reduction_degree = layer.get_property("degree", 1)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        shp = list(self.input_shapes[0])
        d = self.reduction_dim % len(shp)
        if shp[d] % self.reduction_degree:
            raise ValueError("reduction: size not divisible by degree")
        shp[d] //= self.reduction_degree
        return [tuple(shp)]

    def forward(self, params, inputs, ctx: OpContext):
        return [_group_sum(inputs[0], self.reduction_dim,
                           self.reduction_degree)]


@register_op(OperatorType.FUSED_PARALLEL)
class FusedParallelOp(ParallelOpBase):
    """A chain of parallel-op steps as one boundary; property ``ops`` is a
    list of (op_type, dim, degree, axis)."""

    shard_rule = "per_sample"

    def __init__(self, layer, input_shapes):
        self.fused_ops = [
            (OperatorType[k] if isinstance(k, str) else k, d, g, a)
            for (k, d, g, a) in layer.get_property("ops", [])
        ]
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        shp = list(self.input_shapes[0])
        for (kind, dim, degree, _axis) in self.fused_ops:
            if kind == OperatorType.REDUCTION:
                d = dim % len(shp)
                if shp[d] % degree:
                    raise ValueError("fused reduction: size not divisible")
                shp[d] //= degree
        return [tuple(shp)]

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        for (kind, dim, degree, _axis) in self.fused_ops:
            if kind == OperatorType.REDUCTION:
                x = _group_sum(x, dim, degree)
        return [x]

    def preferred_spec_update(self, entries):
        entries = list(entries)
        for (kind, dim, degree, axis) in self.fused_ops:
            if kind == OperatorType.REPARTITION:
                entries[dim % len(entries)] = axis
            elif kind == OperatorType.COMBINE:
                entries[dim % len(entries)] = None
            elif kind == OperatorType.REPLICATE:
                entries = [None] * len(entries)
        return entries
