"""Conv2D, Pool2D and Flat.

PyTorch counterpart of ``flexflow_tpu/ops/conv.py``'s ``Conv2D``,
``Pool2D`` and ``Flat``. The API and parameter layout is NCHW with OIHW
kernels, as in the JAX package, and the port also computes NCHW: the
channels-last execution mode of the JAX package's layout pass
(``exec_layout``) is ROADMAP.md Queue 1 item 9b, as are BatchNorm and
its Conv+BN folds. The convolution is ``F.conv2d`` (cuDNN on the card):
the JAX package convolves through XLA, outside any Pallas kernel, so no
hand kernel stands in for it.

Numerics kept from the reference: the convolution takes x and the
kernel in the compute dtype and returns the compute dtype (no f32
result requested); only then is it cast to f32, the bias added and the
activation applied, and the result cast back to x's dtype. A max pool
counts padding as -inf; an average pool divides by ``kh * kw`` whatever
the padding; a pool's activation follows, in x's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import ActiMode, OperatorType, PoolType
from flexflow_tpu_torch.initializers import (DefaultBiasInitializer,
                                             DefaultWeightInitializer)
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op
from flexflow_tpu_torch.ops.linear import apply_activation

_NCHW_ROLES = (DimRole.SAMPLE, DimRole.CHANNEL, DimRole.OTHER, DimRole.OTHER)


def _window_output(shape, kernel, stride, padding):
    n, c, h, w = shape
    oh = (h + 2 * padding[0] - kernel[0]) // stride[0] + 1
    ow = (w + 2 * padding[1] - kernel[1]) // stride[1] + 1
    return n, c, oh, ow


@register_op(OperatorType.CONV2D)
class Conv2D(Op):
    """x [N, C, H, W] * kernel [Cout, Cin/groups, KH, KW] -> [N, Cout, H',
    W']."""

    def __init__(self, layer, input_shapes):
        p = layer.properties
        self.out_channels = p["out_channels"]
        self.kernel = (p["kernel_h"], p["kernel_w"])
        self.stride = (p["stride_h"], p["stride_w"])
        self.padding = (p["padding_h"], p["padding_w"])
        self.groups = p.get("groups", 1)
        self.activation = p.get("activation", ActiMode.AC_MODE_NONE)
        self.use_bias = p.get("use_bias", True)
        self.kernel_init = (p.get("kernel_initializer")
                            or DefaultWeightInitializer())
        self.bias_init = p.get("bias_initializer") or DefaultBiasInitializer()
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        n, _, oh, ow = _window_output(self.input_shapes[0], self.kernel,
                                      self.stride, self.padding)
        return [(n, self.out_channels, oh, ow)]

    def param_shapes(self):
        c = self.input_shapes[0][1]
        shapes = {"kernel": (self.out_channels, c // self.groups,
                             *self.kernel)}
        if self.use_bias:
            shapes["bias"] = (self.out_channels,)
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
        y = F.conv2d(x.to(cd), params["kernel"].to(cd), stride=self.stride,
                     padding=self.padding, groups=self.groups).float()
        if self.use_bias:
            y = y + params["bias"].float()[None, :, None, None]
        return [apply_activation(y, self.activation).to(x.dtype)]

    def output_dim_roles(self):
        return [_NCHW_ROLES]

    def flops(self):
        n, co, oh, ow = self.output_shapes[0]
        cin = self.input_shapes[0][1]
        return (2 * n * co * oh * ow * (cin // self.groups)
                * self.kernel[0] * self.kernel[1])

    def params_elems(self):
        return sum(math.prod(s) for s in self.param_shapes().values())


@register_op(OperatorType.POOL2D)
class Pool2D(Op):
    def __init__(self, layer, input_shapes):
        p = layer.properties
        self.kernel = (p["kernel_h"], p["kernel_w"])
        self.stride = (p["stride_h"], p["stride_w"])
        self.padding = (p["padding_h"], p["padding_w"])
        self.pool_type = p.get("pool_type", PoolType.POOL_MAX)
        self.activation = p.get("activation", ActiMode.AC_MODE_NONE)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [_window_output(self.input_shapes[0], self.kernel,
                               self.stride, self.padding)]

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        if self.pool_type == PoolType.POOL_MAX:
            y = F.max_pool2d(x, self.kernel, self.stride, self.padding)
        else:
            y = F.avg_pool2d(x, self.kernel, self.stride, self.padding,
                             count_include_pad=True)
        return [apply_activation(y, self.activation)]

    def output_dim_roles(self):
        return [_NCHW_ROLES]


@register_op(OperatorType.FLAT)
class Flat(Op):
    """NCHW -> [N, C*H*W]."""

    def compute_output_shapes(self):
        shp = self.input_shapes[0]
        return [(shp[0], math.prod(shp[1:]))]

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        return [x.reshape(x.shape[0], -1)]

    def output_dim_roles(self):
        return [(DimRole.SAMPLE, DimRole.CHANNEL)]
