"""Split.

PyTorch counterpart of ``flexflow_tpu/ops/tensor_ops.py``'s ``Split``:
the op the search's linear-fusion rewrite emits after the one wide
LINEAR it makes of several (``search/rewrite.py``). Concat, Reshape,
Transpose and the other layout ops come with the op-zoo slice.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op


@register_op(OperatorType.SPLIT)
class Split(Op):
    def __init__(self, layer, input_shapes):
        self.sizes = tuple(layer.get_property("sizes"))
        self.axis = layer.get_property("axis", 0)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        ax = self.axis % len(self.input_shapes[0])
        outs = []
        for sz in self.sizes:
            s = list(self.input_shapes[0])
            s[ax] = sz
            outs.append(tuple(s))
        return outs

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        return list(torch.split(x, list(self.sizes), dim=self.axis))

    def output_dim_roles(self):
        return [tuple(DimRole.SAMPLE if i == 0 else DimRole.OTHER
                      for i in range(len(s)))
                for s in self.output_shapes]
