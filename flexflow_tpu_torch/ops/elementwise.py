"""ElementUnary / ElementBinary / scalar ops.

PyTorch counterpart of ``flexflow_tpu/ops/elementwise.py``: exp, sin,
cos, relu, gelu, sigmoid, tanh, elu, rsqrt, log, identity, the scalar
kinds (multiply, add, sub, true divide, pow) and add, sub, mul, div, max
and min with numpy broadcasting. Each runs in its input's dtype, as the
reference's ``jnp`` functions do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op

_UNARY_FNS = {
    OperatorType.EXP: torch.exp,
    OperatorType.SIN: torch.sin,
    OperatorType.COS: torch.cos,
    OperatorType.RELU: torch.relu,
    # jax.nn.gelu defaults to the tanh approximation
    OperatorType.GELU: lambda x: F.gelu(x, approximate="tanh"),
    OperatorType.SIGMOID: torch.sigmoid,
    OperatorType.TANH: torch.tanh,
    OperatorType.ELU: F.elu,
    OperatorType.RSQRT: torch.rsqrt,
    OperatorType.LOG: torch.log,
    OperatorType.IDENTITY: lambda x: x,
}

_BINARY_FNS = {
    OperatorType.EW_ADD: torch.add,
    OperatorType.EW_SUB: torch.sub,
    OperatorType.EW_MUL: torch.mul,
    OperatorType.EW_DIV: torch.div,
    OperatorType.EW_MAX: torch.maximum,
    OperatorType.EW_MIN: torch.minimum,
}

_SCALAR_FNS = {
    OperatorType.SCALAR_MULTIPLY: lambda x, s: x * s,
    OperatorType.SCALAR_ADD: lambda x, s: x + s,
    OperatorType.SCALAR_SUB: lambda x, s: x - s,
    OperatorType.SCALAR_TRUE_DIV: lambda x, s: x / s,
    OperatorType.POW: torch.pow,
}


class ElementUnary(Op):
    def __init__(self, layer, input_shapes):
        self.scalar = layer.get_property("scalar")
        self.inplace = layer.get_property("inplace", False)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        t = self.layer.op_type
        if t in _SCALAR_FNS:
            return [_SCALAR_FNS[t](x, self.scalar)]
        return [_UNARY_FNS[t](x)]

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


for _t in list(_UNARY_FNS) + list(_SCALAR_FNS):
    register_op(_t)(type(f"ElementUnary_{_t.name}", (ElementUnary,), {}))
for _t in _BINARY_FNS:
    register_op(_t)(type(f"ElementBinary_{_t.name}", (ElementBinary,), {}))
