"""LayerNorm, GroupNorm, RMSNorm, Softmax and Dropout.

PyTorch counterpart of ``flexflow_tpu/ops/norm.py``: statistics, the
affine apply and the softmax in f32, the result in the input's dtype.
GroupNorm computes on a channels-last view of its input, so one path
serves an NCHW value and a ``torch.channels_last`` one (see
``ops/conv.py``). Dropout draws its mask from the model's
``torch.Generator`` (``OpContext.next_rng``); JAX's PRNG has no torch
twin, so its masks are the reference's in distribution, not bit for bit.
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op
from flexflow_tpu_torch.ops.elementwise import _elementwise_roles


@register_op(OperatorType.LAYERNORM)
class LayerNorm(Op):
    @property
    def shard_rule(self):
        nd = len(self.input_shapes[0])
        return ("whole" if 0 in {a % nd for a in self.axes}
                else "per_sample")

    def __init__(self, layer, input_shapes):
        self.axes = tuple(layer.get_property("axes", (-1,)))
        self.elementwise_affine = layer.get_property("elementwise_affine", True)
        self.eps = layer.get_property("eps", 1e-5)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.input_shapes[0]]

    def _norm_shape(self):
        shp = self.input_shapes[0]
        axes = tuple(a % len(shp) for a in self.axes)
        return tuple(shp[a] for a in sorted(axes))

    def param_shapes(self):
        if not self.elementwise_affine:
            return {}
        ns = self._norm_shape()
        return {"scale": ns, "bias": ns}

    def init_params(self, generator):
        shapes = self.param_shapes()
        if not shapes:
            return {}
        dev = generator.device
        return {"scale": torch.ones(shapes["scale"], device=dev),
                "bias": torch.zeros(shapes["bias"], device=dev)}

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=self.axes, keepdim=True,
                                   correction=0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.elementwise_affine:
            y = y * params["scale"].float() + params["bias"].float()
        return [y.to(x.dtype)]

    def output_dim_roles(self):
        shp = self.output_shapes[0]
        roles = [DimRole.SAMPLE] + [DimRole.OTHER] * (len(shp) - 1)
        norm_axes = {a % len(shp) for a in self.axes}
        if len(shp) == 3 and 1 not in norm_axes:
            roles[1] = DimRole.SEQ
        return [tuple(roles)]

    def params_elems(self):
        return 2 * math.prod(self._norm_shape()) if self.elementwise_affine else 0


@register_op(OperatorType.GROUPNORM)
class GroupNorm(Op):
    """``nn.GroupNorm`` for NCHW / NC inputs: each of ``groups`` channel
    groups normalized over (C/G, *spatial), a per-channel affine."""

    shard_rule = "per_sample"

    def __init__(self, layer, input_shapes):
        self.groups = layer.get_property("groups", 1)
        self.eps = layer.get_property("eps", 1e-5)
        self.affine = layer.get_property("affine", True)
        c = input_shapes[0][1]
        if c % self.groups:
            raise ValueError(
                f"group_norm: {c} channels not divisible by "
                f"{self.groups} groups")
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.input_shapes[0]]

    def param_shapes(self):
        if not self.affine:
            return {}
        c = self.input_shapes[0][1]
        return {"scale": (c,), "bias": (c,)}

    def init_params(self, generator):
        if not self.affine:
            return {}
        c = self.input_shapes[0][1]
        dev = generator.device
        return {"scale": torch.ones(c, device=dev),
                "bias": torch.zeros(c, device=dev)}

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        g, c = self.groups, x.shape[1]
        # channels last as a view, C split into (g, c/g): each group
        # normalizes over (*spatial, c/g); a view on NCHW and on
        # channels-last memory alike, so the result keeps x's format
        xc = x.movedim(1, -1)
        xf = xc.float().reshape(xc.shape[:-1] + (g, c // g))
        axes = tuple(range(1, xf.dim() - 2)) + (xf.dim() - 1,)
        mean = xf.mean(dim=axes, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=axes, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(xc.shape)
        if self.affine:
            y = y * params["scale"].float() + params["bias"].float()
        return [y.to(x.dtype).movedim(-1, 1)]

    def params_elems(self):
        return 2 * int(self.input_shapes[0][1]) if self.affine else 0


@register_op(OperatorType.RMSNORM)
class RMSNorm(Op):
    """Root-mean-square normalization over the last dim (the Llama
    family): y = x / rms(x) * scale, computed in f32."""

    shard_rule = "per_sample"

    def __init__(self, layer, input_shapes):
        self.eps = layer.get_property("eps", 1e-6)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.input_shapes[0]]

    def param_shapes(self):
        return {"scale": (self.input_shapes[0][-1],)}

    def init_params(self, generator):
        return {"scale": torch.ones(self.param_shapes()["scale"],
                                    device=generator.device)}

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        xf = x.float()
        rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                          + self.eps)
        return [(xf * rms * params["scale"].float()).to(x.dtype)]

    def output_dim_roles(self):
        shp = self.output_shapes[0]
        roles = [DimRole.SAMPLE] + [DimRole.OTHER] * (len(shp) - 1)
        if len(shp) == 3:
            roles[1] = DimRole.SEQ  # a per-position norm
        return [tuple(roles)]

    def params_elems(self):
        return int(self.input_shapes[0][-1])


@register_op(OperatorType.SOFTMAX)
class Softmax(Op):
    @property
    def shard_rule(self):
        return ("whole" if self.axis % len(self.input_shapes[0]) == 0
                else "per_sample")

    def __init__(self, layer, input_shapes):
        self.axis = layer.get_property("axis", -1)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        return [torch.softmax(x.float(), dim=self.axis).to(x.dtype)]

    def output_dim_roles(self):
        shp = self.output_shapes[0]
        roles = [DimRole.SAMPLE] + [DimRole.OTHER] * (len(shp) - 1)
        if len(shp) == 3 and self.axis % len(shp) != 1:
            roles[1] = DimRole.SEQ
        return [tuple(roles)]


@register_op(OperatorType.DROPOUT)
class Dropout(Op):
    """Zeroes each element with probability ``rate`` in training and
    scales the rest by ``1 / (1 - rate)``; the identity outside training
    and at rate 0. The mask keeps x's memory format."""

    shard_rule = "elementwise"

    def __init__(self, layer, input_shapes):
        self.rate = layer.get_property("rate", 0.5)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        if not ctx.training or self.rate <= 0.0:
            return [x]
        keep = (torch.empty_like(x, dtype=torch.float32)
                .uniform_(generator=ctx.next_rng()) < 1.0 - self.rate)
        return [torch.where(keep, x / (1.0 - self.rate), 0.0).to(x.dtype)]

    def output_dim_roles(self):
        return [_elementwise_roles(self.output_shapes[0])]
