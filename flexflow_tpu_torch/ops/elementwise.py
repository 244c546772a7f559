"""ElementUnary (RELU) and ElementBinary (EW_ADD).

PyTorch counterpart of ``flexflow_tpu/ops/elementwise.py`` for the two
kinds this slice's model uses; the other unary, binary and scalar kinds
come with the op-zoo slice.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op

_UNARY_FNS = {
    OperatorType.RELU: torch.relu,
}

_BINARY_FNS = {
    OperatorType.EW_ADD: torch.add,
}


class ElementUnary(Op):
    def compute_output_shapes(self):
        return [self.input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        return [_UNARY_FNS[self.layer.op_type](x)]

    def output_dim_roles(self):
        return [_elementwise_roles(self.output_shapes[0])]


class ElementBinary(Op):
    def compute_output_shapes(self):
        a, b = self.input_shapes
        return [tuple(torch.broadcast_shapes(a, b))]

    def forward(self, params, inputs, ctx: OpContext):
        a, b = inputs
        return [_BINARY_FNS[self.layer.op_type](a, b)]

    def output_dim_roles(self):
        return [_elementwise_roles(self.output_shapes[0])]


def _elementwise_roles(shp):
    """dim0 sample; dim1 of a rank-3 tensor is a position dim (SEQ)."""
    roles = [DimRole.SAMPLE if i == 0 else DimRole.OTHER
             for i in range(len(shp))]
    if len(shp) == 3:
        roles[1] = DimRole.SEQ
    return tuple(roles)


for _t in _UNARY_FNS:
    register_op(_t)(type(f"ElementUnary_{_t.name}", (ElementUnary,), {}))
for _t in _BINARY_FNS:
    register_op(_t)(type(f"ElementBinary_{_t.name}", (ElementBinary,), {}))
