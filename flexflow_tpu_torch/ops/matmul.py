"""BatchMatmul.

PyTorch counterpart of ``flexflow_tpu/ops/matmul.py``: ``a [..., M, K] @
b [..., K, N]`` with numpy broadcasting over the leading dims, as
``torch.matmul`` in the compute dtype (cuBLAS on the card, f32
accumulation), the result in the first input's dtype, as
``ops/linear.py`` computes its product. ``a_seq_length_dim`` /
``b_seq_length_dim`` name the dims a shorter ``seq_length`` would slice
in the JAX package; they are kept as the layer's properties (the search
metadata), and the port runs the full extent: its steps take no shorter
``seq_length`` (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op


@register_op(OperatorType.BATCHMATMUL)
class BatchMatmul(Op):
    """a: [..., M, K] @ b: [..., K, N] -> [..., M, N]."""

    def __init__(self, layer, input_shapes):
        self.a_seq_length_dim = layer.get_property("a_seq_length_dim", -1)
        self.b_seq_length_dim = layer.get_property("b_seq_length_dim", -1)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        a, b = self.input_shapes
        assert a[-1] == b[-2], f"batch_matmul contraction mismatch {a} @ {b}"
        return [tuple(a[:-1]) + (b[-1],)]

    def forward(self, params, inputs, ctx: OpContext):
        a, b = inputs
        cd = ctx.compute_dtype
        y = torch.matmul(a.to(cd), b.to(cd))
        return [y.to(inputs[0].dtype)]

    def output_dim_roles(self):
        shp = self.output_shapes[0]
        return [tuple(DimRole.SAMPLE if i == 0 else DimRole.OTHER
                      for i in range(len(shp)))]

    def flops(self):
        a, b = self.input_shapes
        batch = math.prod(a[:-2])
        return 2 * batch * a[-2] * a[-1] * b[-1]
