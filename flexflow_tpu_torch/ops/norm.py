"""LayerNorm, RMSNorm and Softmax.

PyTorch counterpart of ``flexflow_tpu/ops/norm.py``'s ``LayerNorm``,
``RMSNorm`` and ``Softmax``: statistics, the affine apply and the
softmax in f32, the result in the input's dtype. GroupNorm and Dropout
come with later slices.
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op


@register_op(OperatorType.LAYERNORM)
class LayerNorm(Op):
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


@register_op(OperatorType.RMSNORM)
class RMSNorm(Op):
    """Root-mean-square normalization over the last dim (the Llama
    family): y = x / rms(x) * scale, computed in f32."""

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
