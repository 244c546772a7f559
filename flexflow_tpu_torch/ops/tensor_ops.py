"""Concat and Split.

PyTorch counterpart of ``flexflow_tpu/ops/tensor_ops.py``'s ``Concat``
and ``Split``: Concat joins the recommendation models' embeddings and
towers and Inception's branches; Split is the op the search's
linear-fusion rewrite emits after the one wide LINEAR it makes of
several (``search/rewrite.py``). Both are pure data movement. The port
computes the conv family in NCHW (``FFModel.compile``'s
``layout_info``), so Concat's axis is the logical one as given, with
no channels-last remap. Reshape, Transpose and the other layout ops are
ROADMAP.md Queue 1 item 9c.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op


def _default_roles(shp):
    return tuple(DimRole.SAMPLE if i == 0 else DimRole.OTHER
                 for i in range(len(shp)))


@register_op(OperatorType.CONCAT)
class Concat(Op):
    def __init__(self, layer, input_shapes):
        self.axis = layer.get_property("axis", 0)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        ax = self.axis % len(self.input_shapes[0])
        out = list(self.input_shapes[0])
        out[ax] = sum(s[ax] for s in self.input_shapes)
        return [tuple(out)]

    def forward(self, params, inputs, ctx: OpContext):
        return [torch.cat(inputs, dim=self.axis)]

    def output_dim_roles(self):
        return [_default_roles(self.output_shapes[0])]


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
        return [_default_roles(s) for s in self.output_shapes]
