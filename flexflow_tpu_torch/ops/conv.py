"""Conv2D, Pool2D, BatchNorm and Flat.

PyTorch counterpart of ``flexflow_tpu/ops/conv.py``. The API and the
parameter layout are NCHW with OIHW kernels, as in the JAX package. The
layout pass (``layout.propagate_layouts``) may have the conv family run
channels-last: there a value is still a logical ``[N, C, H, W]``
tensor, held in ``torch.channels_last`` memory, so these forwards read the same dims in
either mode and cuDNN convolves NHWC without transforming around each
call; the parameters stay contiguous OIHW. The convolution is
``F.conv2d`` (cuDNN on the card): the JAX package convolves through XLA,
outside any Pallas kernel, so no hand kernel stands in for it, nor for
BatchNorm, which XLA generates too.

Numerics kept from the reference: the convolution takes x and the
kernel in the compute dtype and returns the compute dtype (no f32
result requested); only then is it cast to f32, the bias added and the
activation applied, and the result cast back to x's dtype. A max pool
counts padding as -inf; an average pool divides by ``kh * kw`` whatever
the padding; a pool's activation follows, in x's dtype. BatchNorm takes
its statistics over N, H, W of x in f32 (the biased variance), applies
``(x - mean) * (rsqrt(var + eps) * scale) + bias`` and the optional ReLU
in f32 and casts back; its running statistics (op state, f32) move as
``momentum * old + (1 - momentum) * batch`` with the biased variance
(not ``F.batch_norm``'s convention), and eval normalizes with them.
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
        return [self._conv_forward(params["kernel"],
                                   params.get("bias") if self.use_bias
                                   else None, x, ctx, self.activation)]

    def _conv_forward(self, kernel, bias, x, ctx: OpContext, activation):
        """The shared conv core: ``kernel`` OIHW, ``bias`` [Cout] or None,
        then the f32 bias and activation epilogue. Also the body of the
        Conv+BN eval fold (``layout.FoldedConvBN``)."""
        cd = ctx.compute_dtype
        y = F.conv2d(x.to(cd), kernel.to(cd), stride=self.stride,
                     padding=self.padding, groups=self.groups).float()
        if bias is not None:
            y = y + bias.float()[None, :, None, None]
        return apply_activation(y, activation).to(x.dtype)

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


@register_op(OperatorType.BATCHNORM)
class BatchNorm(Op):
    """Batch normalization over N, H, W of an NCHW input. Its running
    statistics are op state (``init_state``), kept apart from the
    parameters and updated outside autograd: ``forward_with_state``
    returns the new state beside the output."""

    def __init__(self, layer, input_shapes):
        self.relu = layer.get_property("relu", True)
        self.momentum = layer.get_property("momentum", 0.9)
        self.eps = layer.get_property("eps", 1e-5)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.input_shapes[0]]

    def param_shapes(self):
        c = self.input_shapes[0][1]
        return {"scale": (c,), "bias": (c,)}

    def init_params(self, generator):
        c = self.input_shapes[0][1]
        dev = generator.device
        return {"scale": torch.ones(c, device=dev),
                "bias": torch.zeros(c, device=dev)}

    def init_state(self, device):
        c = self.input_shapes[0][1]
        return {"mean": torch.zeros(c, device=device),
                "var": torch.ones(c, device=device)}

    def forward(self, params, inputs, ctx: OpContext, state=None):
        return self.forward_with_state(params, inputs, ctx, state)[0]

    def forward_with_state(self, params, inputs, ctx: OpContext, state):
        """-> (outputs, the new running statistics): in training the batch
        statistics normalize and, with ``state``, move it; in eval
        ``state`` normalizes (the batch's statistics without one) and
        stays. The new state is None where it does not move."""
        (x,) = inputs
        xf = x.float()
        new_state = None
        if ctx.training or state is None:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        if ctx.training and state is not None:
            m = self.momentum
            new_state = {"mean": m * state["mean"] + (1 - m) * mean.detach(),
                         "var": m * state["var"] + (1 - m) * var.detach()}
        elif state is not None:
            mean, var = state["mean"], state["var"]
        inv = torch.rsqrt(var + self.eps) * params["scale"].float()
        y = ((xf - mean[None, :, None, None]) * inv[None, :, None, None]
             + params["bias"].float()[None, :, None, None])
        if self.relu:
            y = torch.relu(y)
        return [y.to(x.dtype)], new_state

    def output_dim_roles(self):
        return [_NCHW_ROLES]

    def params_elems(self):
        return 2 * self.input_shapes[0][1]


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
