"""ReduceSum, Mean, TopK and ArgTopK.

PyTorch counterpart of ``flexflow_tpu/ops/reduce.py``. TopK and ArgTopK
take ``top_k``: ``lax.top_k``'s order (sorted, largest first, the lower
index first among equal values), which ``torch.topk`` does not keep on
tied entries. The MoE ops route through the same rule. The indices are
int64 here, int32 in the JAX package.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import Op, OpContext, register_op


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last dim,
    largest first and, among equal values, the lower index first, as
    ``jax.lax.top_k`` orders them: a stable descending sort, cut to
    ``k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _reduced_shape(shape, axes, keepdims):
    axes = tuple(a % len(shape) for a in axes)
    if keepdims:
        return tuple(1 if i in axes else s for i, s in enumerate(shape))
    return tuple(s for i, s in enumerate(shape) if i not in axes)


@register_op(OperatorType.REDUCE_SUM)
class ReduceSum(Op):
    def __init__(self, layer, input_shapes):
        self.axes = tuple(layer.get_property("axes"))
        self.keepdims = layer.get_property("keepdims", False)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [_reduced_shape(self.input_shapes[0], self.axes, self.keepdims)]

    def forward(self, params, inputs, ctx: OpContext):
        return [torch.sum(inputs[0], dim=self.axes, keepdim=self.keepdims)]


@register_op(OperatorType.MEAN)
class Mean(Op):
    def __init__(self, layer, input_shapes):
        self.axes = tuple(layer.get_property("axes"))
        self.keepdims = layer.get_property("keepdims", False)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [_reduced_shape(self.input_shapes[0], self.axes, self.keepdims)]

    def forward(self, params, inputs, ctx: OpContext):
        return [torch.mean(inputs[0], dim=self.axes, keepdim=self.keepdims)]


@register_op(OperatorType.TOPK)
class TopK(Op):
    """(values, indices) of the k largest along the last dim."""

    def __init__(self, layer, input_shapes):
        self.k = layer.get_property("k")
        self.sorted = layer.get_property("sorted", True)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        s = tuple(self.input_shapes[0][:-1]) + (self.k,)
        return [s, s]

    def forward(self, params, inputs, ctx: OpContext):
        vals, idx = top_k(inputs[0], self.k)
        return [vals, idx]


@register_op(OperatorType.ARG_TOPK)
class ArgTopK(Op):
    def __init__(self, layer, input_shapes):
        self.k = layer.get_property("k")
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [tuple(self.input_shapes[0][:-1]) + (self.k,)]

    def forward(self, params, inputs, ctx: OpContext):
        return [top_k(inputs[0], self.k)[1]]
