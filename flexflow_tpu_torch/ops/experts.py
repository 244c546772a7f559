"""Fused MoE Experts op: gate -> top-k dispatch -> expert FFN -> combine.

PyTorch counterpart of ``flexflow_tpu/ops/experts.py``: the experts are
one op with stacked weights ``w_h [E, D, H]``, ``b_h [E, H]``, ``w_o
[E, H, D]``, ``b_o [E, D]``. Routing is ``reduce.top_k`` of the router's
probabilities (``lax.top_k``'s order among ties), then the dispatch and
combine tensors of ``ops/moe.py``; the FFN is ``dense_moe_ffn``, f32
einsums and a ReLU cast back to the input's dtype, as the JAX package's
replicated path computes it. The load-balance loss over all top-k slots
comes out beside the output (``forward_with_aux``).

The JAX package shards the stacked weights' leading dim over an
``expert`` mesh axis when the search picks an ``_ep`` choice
(``parallel/expert.py`` ``expert_parallel_ffn``); the port runs one
device, and an expert axis above 1 raises, naming the multi-GPU item.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.initializers import DefaultWeightInitializer
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op
from flexflow_tpu_torch.ops.moe import (expert_capacity, load_balance_loss,
                                        make_dispatch_tensors)
from flexflow_tpu_torch.ops.reduce import top_k


def dense_moe_ffn(x, dispatch, combine, w_h, b_h, w_o, b_o,
                  activation=torch.relu):
    """The experts' FFN on one device: group the tokens into each
    expert's capacity buffer, run every expert's two layers as batched
    einsums, combine by the gates; all in f32, the result in ``x``'s
    dtype."""
    grouped = torch.einsum("bd,bkec->ecd", x.float(), dispatch.float())
    h = torch.einsum("ecd,edh->ech", grouped, w_h.float())
    h = activation(h + b_h.float()[:, None, :])
    o = torch.einsum("ech,ehd->ecd", h, w_o.float())
    o = o + b_o.float()[:, None, :]
    y = torch.einsum("bkec,ecd->bd", combine.float(), o)
    return y.to(x.dtype)


@register_op(OperatorType.EXPERTS)
class Experts(Op):
    """inputs: (x [B, D], gate [B, E] router probabilities) -> [B, D]."""

    def __init__(self, layer, input_shapes):
        p = layer.properties
        self.n_experts = p["n"]
        self.k = p.get("k", 1)
        self.hidden_size = p["hidden_size"]
        self.alpha = p.get("alpha", 2.0)
        self.lambda_bal = p.get("lambda_bal", 0.0)
        # the mesh axis the experts shard over (an "_ep" choice)
        self.expert_parallel = p.get("expert_parallel", None)
        self.kernel_init = (p.get("kernel_initializer")
                            or DefaultWeightInitializer())
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        b, d = self.input_shapes[0]
        return [(b, d)]

    def param_shapes(self):
        e, h = self.n_experts, self.hidden_size
        d = self.input_shapes[0][-1]
        return {"w_h": (e, d, h), "b_h": (e, h), "w_o": (e, h, d),
                "b_o": (e, d)}

    def init_params(self, generator):
        shapes = self.param_shapes()
        dev = generator.device
        return {"w_h": self.kernel_init(generator, shapes["w_h"]),
                "b_h": torch.zeros(shapes["b_h"], device=dev),
                "w_o": self.kernel_init(generator, shapes["w_o"]),
                "b_o": torch.zeros(shapes["b_o"], device=dev)}

    def forward(self, params, inputs, ctx: OpContext):
        return self.forward_with_aux(params, inputs, ctx)[0]

    def forward_with_aux(self, params, inputs, ctx: OpContext):
        """-> (outputs, the load-balance loss or None)."""
        x, gate = inputs
        axis = self.expert_parallel
        if axis and ctx.mesh_axes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"{self.name}: experts over the mesh axis {axis!r} "
                f"({ctx.mesh_axes[axis]} devices) need multi-GPU "
                f"execution, the multi-GPU slice of the PyTorch port "
                f"(ROADMAP.md Queue 1 item 3)")
        b = x.shape[0]
        values, assign = top_k(gate, self.k)
        cap = expert_capacity(b, self.k, self.n_experts, self.alpha)
        dispatch, combine = make_dispatch_tensors(
            assign, values.float(), self.n_experts, cap)
        y = dense_moe_ffn(x, dispatch, combine, params["w_h"],
                          params["b_h"], params["w_o"], params["b_o"])
        aux = None
        if self.lambda_bal > 0.0:
            aux = load_balance_loss(assign, gate, self.n_experts,
                                    self.lambda_bal)
        return [y], aux

    def output_dim_roles(self):
        return [(DimRole.SAMPLE, DimRole.CHANNEL)]

    def flops(self):
        b, d = self.input_shapes[0]
        cap = expert_capacity(b, self.k, self.n_experts, self.alpha)
        e, h = self.n_experts, self.hidden_size
        ffn = 2 * e * cap * d * h * 2
        route = 2 * b * self.k * e * cap * d * 2  # dispatch + combine einsums
        return ffn + route

    def params_elems(self):
        e, h = self.n_experts, self.hidden_size
        d = self.input_shapes[0][-1]
        return e * (d * h + h + h * d + d)
