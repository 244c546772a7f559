"""Shape and layout ops: Concat, Split, Reshape, Transpose, Reverse, Cast,
Const, Where, Expand, Einsum, ReduceMax and Gather.

PyTorch counterpart of ``flexflow_tpu/ops/tensor_ops.py``. Concat joins
the recommendation models' embeddings and towers and Inception's
branches; Split is also the op the search's linear-fusion rewrite emits
after the one wide LINEAR it makes of several (``search/rewrite.py``).
The rest are the tensor-op surface the frontends (``torch/``, ``onnx/``,
``keras/``) import arbitrary graphs into. All but Einsum are data
movement or elementwise selection; Einsum contracts in the compute dtype
(f32 accumulation), as ``ops/matmul.py`` does. Concat's axis is the
logical one as given: the layout pass hands these ops NCHW values.

Where the JAX package runs without 64-bit types, the port keeps torch's:
``cast`` to ``DT_INT64`` gives int64 here and int32 there, and
``Gather`` takes int64 indices (the values agree).
"""

from __future__ import annotations

from collections import Counter
import math

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import DataType, OperatorType
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


@register_op(OperatorType.RESHAPE)
class Reshape(Op):
    def __init__(self, layer, input_shapes):
        self.target = tuple(layer.get_property("shape"))
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.target]

    def forward(self, params, inputs, ctx: OpContext):
        return [inputs[0].reshape(self.target)]

    def output_dim_roles(self):
        return [_default_roles(self.output_shapes[0])]


@register_op(OperatorType.TRANSPOSE)
class Transpose(Op):
    def __init__(self, layer, input_shapes):
        self.perm = tuple(layer.get_property("perm"))
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        s = self.input_shapes[0]
        return [tuple(s[p] for p in self.perm)]

    def forward(self, params, inputs, ctx: OpContext):
        return [inputs[0].permute(self.perm)]

    def output_dim_roles(self):
        return [_default_roles(self.output_shapes[0])]


@register_op(OperatorType.REVERSE)
class Reverse(Op):
    def __init__(self, layer, input_shapes):
        self.axis = layer.get_property("axis", 0)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        return [torch.flip(inputs[0], dims=(self.axis,))]


@register_op(OperatorType.CAST)
class Cast(Op):
    shard_rule = "elementwise"

    def __init__(self, layer, input_shapes):
        self.target_dtype: DataType = layer.get_property("dtype")
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        return [inputs[0].to(self.target_dtype.torch_dtype)]


@register_op(OperatorType.CONST)
class Const(Op):
    """Embedded constant tensor (torch.fx ``get_attr`` buffers, e.g. a
    GPT-2 causal mask registered as a module buffer). With
    ``trainable=True`` the value becomes a leaf parameter ``weight`` that
    the optimizer updates (a bare ``nn.Parameter`` used directly in
    forward, e.g. a learned positional embedding). A fixed value lives on
    the device once per device: the compiled steps' warm-up puts it
    there, before any capture, and their graphs read it."""

    def __init__(self, layer, input_shapes):
        self.value = np.asarray(layer.get_property("value"))
        self.trainable = bool(layer.get_property("trainable", False))
        self._on_device = {}
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [tuple(self.value.shape)]

    def param_shapes(self):
        return {"weight": tuple(self.value.shape)} if self.trainable else {}

    def init_params(self, generator):
        if not self.trainable:
            return {}
        return {"weight": torch.tensor(self.value, dtype=torch.float32,
                                       device=generator.device)}

    def forward(self, params, inputs, ctx: OpContext):
        if self.trainable:
            return [params["weight"]]
        device = torch.device(ctx.device or "cpu")
        if device not in self._on_device:
            t = torch.as_tensor(self.value)
            # float64 computes as float32, the JAX package's precision
            if t.dtype == torch.float64:
                t = t.float()
            self._on_device[device] = t.to(device)
        return [self._on_device[device]]

    def params_elems(self):
        return int(self.value.size) if self.trainable else 0

    def output_dim_roles(self):
        return [tuple(DimRole.OTHER for _ in self.value.shape)]


@register_op(OperatorType.WHERE)
class Where(Op):
    """select(cond, a, b): torch.where / masked_fill. ``cond`` may be
    bool or a 0/1 float mask (nonzero is true, as in ``jnp.where``);
    broadcasting follows numpy rules."""

    def compute_output_shapes(self):
        return [tuple(np.broadcast_shapes(*self.input_shapes))]

    def forward(self, params, inputs, ctx: OpContext):
        cond, a, b = inputs
        return [torch.where(cond.to(torch.bool), a, b)]

    def output_dim_roles(self):
        return [_default_roles(self.output_shapes[0])]


@register_op(OperatorType.EXPAND)
class Expand(Op):
    """broadcast_to (torch expand / repeat with unit source dims)."""

    def __init__(self, layer, input_shapes):
        self.target = tuple(layer.get_property("shape"))
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.target]

    def forward(self, params, inputs, ctx: OpContext):
        return [torch.broadcast_to(inputs[0], self.target)]

    def output_dim_roles(self):
        return [_default_roles(self.output_shapes[0])]


def _einsum_sizes(equation, input_shapes):
    lhs, _, out = equation.replace(" ", "").partition("->")
    terms = lhs.split(",")
    sizes = {}
    for term, shp in zip(terms, input_shapes):
        for ch, d in zip(term, shp):
            sizes[ch] = d
    return terms, out, sizes


@register_op(OperatorType.EINSUM)
class Einsum(Op):
    """General einsum contraction (torch.einsum), in the compute dtype
    with f32 accumulation; the result in the first input's dtype."""

    def __init__(self, layer, input_shapes):
        self.equation = layer.get_property("equation")
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        terms, out, sizes = _einsum_sizes(self.equation, self.input_shapes)
        if not out and "->" not in self.equation:
            # implicit output: sorted letters appearing exactly once
            c = Counter("".join(terms))
            out = "".join(sorted(ch for ch, k in c.items() if k == 1))
        return [tuple(sizes[ch] for ch in out)]

    def forward(self, params, inputs, ctx: OpContext):
        cd = ctx.compute_dtype
        y = torch.einsum(self.equation, *[x.to(cd) for x in inputs])
        return [y.to(inputs[0].dtype)]

    def flops(self):
        _, _, sizes = _einsum_sizes(self.equation, self.input_shapes)
        return 2 * math.prod(sizes.values())

    def output_dim_roles(self):
        return [_default_roles(self.output_shapes[0])]


@register_op(OperatorType.REDUCE_MAX)
class ReduceMax(Op):
    def __init__(self, layer, input_shapes):
        self.axes = tuple(layer.get_property("axes"))
        self.keepdims = layer.get_property("keepdims", False)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        s = list(self.input_shapes[0])
        axes = sorted(a % len(s) for a in self.axes)
        for a in reversed(axes):
            if self.keepdims:
                s[a] = 1
            else:
                s.pop(a)
        return [tuple(s)]

    def forward(self, params, inputs, ctx: OpContext):
        return [torch.amax(inputs[0], dim=self.axes, keepdim=self.keepdims)]

    def output_dim_roles(self):
        return [_default_roles(self.output_shapes[0])]


@register_op(OperatorType.GATHER)
class Gather(Op):
    """take_along_axis gather: out[idx] along ``axis``; the index input
    may be integral or float (truncated, as the reference's int cast)."""

    def __init__(self, layer, input_shapes):
        self.axis = layer.get_property("axis", 0)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.input_shapes[1]]

    def forward(self, params, inputs, ctx: OpContext):
        x, idx = inputs
        return [torch.gather(x, self.axis, idx.long())]
