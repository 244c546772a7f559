"""Linear (dense) operator: y = act(x W + b).

PyTorch counterpart of ``flexflow_tpu/ops/linear.py``. The kernel layout
stays ``[in, out]``. The matmul is ``torch.matmul`` in the compute dtype
(cuBLAS on the card, f32 accumulation), as the JAX package leaves it to
XLA; bias and activation are applied in f32 and the result returns in
the input's dtype.
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.ffconst import ActiMode, OperatorType
from flexflow_tpu_torch.initializers import (DefaultBiasInitializer,
                                             DefaultWeightInitializer)
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op


def apply_activation(x: torch.Tensor, act: ActiMode) -> torch.Tensor:
    if act == ActiMode.AC_MODE_RELU:
        return torch.relu(x)
    if act == ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(x)
    if act == ActiMode.AC_MODE_TANH:
        return torch.tanh(x)
    if act == ActiMode.AC_MODE_GELU:
        # jax.nn.gelu defaults to the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    return x


@register_op(OperatorType.LINEAR)
class Linear(Op):
    def __init__(self, layer, input_shapes):
        self.out_dim = layer.get_property("out_dim")
        self.activation = layer.get_property("activation", ActiMode.AC_MODE_NONE)
        self.use_bias = layer.get_property("use_bias", True)
        self.kernel_init = layer.get_property("kernel_initializer") or DefaultWeightInitializer()
        self.bias_init = layer.get_property("bias_initializer") or DefaultBiasInitializer()
        super().__init__(layer, input_shapes)
        self.in_dim = self.input_shapes[0][-1]

    def compute_output_shapes(self):
        (in_shape,) = self.input_shapes
        return [tuple(in_shape[:-1]) + (self.out_dim,)]

    def param_shapes(self):
        shapes = {"kernel": (self.in_dim, self.out_dim)}
        if self.use_bias:
            shapes["bias"] = (self.out_dim,)
        return shapes

    def init_params(self, generator):
        shapes = self.param_shapes()
        params = {"kernel": self.kernel_init(generator, shapes["kernel"])}
        if self.use_bias:
            params["bias"] = self.bias_init(generator, shapes["bias"])
        return params

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        cd = ctx.compute_dtype
        y = torch.matmul(x.to(cd), params["kernel"].to(cd)).float()
        if self.use_bias:
            y = y + params["bias"].float()
        y = apply_activation(y, self.activation)
        return [y.to(x.dtype)]

    def output_dim_roles(self):
        shp = self.output_shapes[0]
        mid = DimRole.SEQ if len(shp) == 3 else DimRole.OTHER
        roles = [DimRole.SAMPLE] + [mid] * (len(shp) - 2) + [DimRole.CHANNEL]
        return [tuple(roles)]

    def flops(self):
        batch = math.prod(self.input_shapes[0][:-1])
        return 2 * batch * self.in_dim * self.out_dim

    def params_elems(self):
        return self.in_dim * self.out_dim + (self.out_dim if self.use_bias else 0)
