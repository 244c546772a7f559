"""Embedding.

PyTorch counterpart of ``flexflow_tpu/ops/embedding.py``: a lookup of
token ids in a ``[num_entries, out_dim]`` table, aggregated over the bag
(the last input dim) by SUM or AVG, or not at all (NONE: one row a
position). Ids arrive as int32 or int64 and index as int64.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import AggrMode, OperatorType
from flexflow_tpu_torch.initializers import DefaultWeightInitializer
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op


@register_op(OperatorType.EMBEDDING)
class Embedding(Op):
    """input ids [B, S] (int) -> [B, out_dim] (SUM/AVG over S) or
    [B, S, out_dim] (AGGR_MODE_NONE)."""

    def __init__(self, layer, input_shapes):
        p = layer.properties
        self.num_entries = p["num_entries"]
        self.out_dim = p["out_dim"]
        self.aggr = p.get("aggr", AggrMode.AGGR_MODE_NONE)
        self.kernel_init = (p.get("kernel_initializer")
                            or DefaultWeightInitializer())
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        in_shape = tuple(self.input_shapes[0])
        if self.aggr == AggrMode.AGGR_MODE_NONE:
            return [in_shape + (self.out_dim,)]
        return [in_shape[:-1] + (self.out_dim,)]

    def param_shapes(self):
        return {"kernel": (self.num_entries, self.out_dim)}

    def init_params(self, generator):
        return {"kernel": self.kernel_init(generator,
                                           self.param_shapes()["kernel"])}

    def forward(self, params, inputs, ctx: OpContext):
        (ids,) = inputs
        emb = params["kernel"][ids.long()]
        if self.aggr == AggrMode.AGGR_MODE_SUM:
            emb = torch.sum(emb, dim=-2)
        elif self.aggr == AggrMode.AGGR_MODE_AVG:
            emb = torch.mean(emb, dim=-2)
        return [emb]

    def output_dim_roles(self):
        # the token-position dim of a [B, S, E] output is a sequence dim
        # (each position's lookup stands alone)
        shp = self.output_shapes[0]
        mid = DimRole.SEQ if len(shp) == 3 else DimRole.OTHER
        roles = [DimRole.SAMPLE] + [mid] * (len(shp) - 2) + [DimRole.CHANNEL]
        return [tuple(roles)]

    def params_elems(self):
        return self.num_entries * self.out_dim
