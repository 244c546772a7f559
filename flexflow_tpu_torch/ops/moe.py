"""Mixture-of-Experts ops: GroupBy, Aggregate, AggregateSpec, Cache.

PyTorch counterpart of ``flexflow_tpu/ops/moe.py``. Dispatch is
GShard-style: one-hot dispatch and combine tensors ``[B, K, E, C]`` with
a fixed capacity for each expert (``expert_capacity``, the capacity factor
``alpha``), contracted by f32 einsums; a token past its expert's
capacity is dropped. The one-hot masks are comparisons with ``arange``,
so a position past the capacity gives a zero row as ``jax.nn.one_hot``
does (``torch.nn.functional.one_hot`` raises there, and on CUDA checks
its values with a host sync that a CUDA-graph capture refuses).

Aggregate returns the Switch/GShard load-balance loss beside its output
(``forward_with_aux``): the executor adds it to the training objective,
as the JAX package adds the ``_aux_loss`` its op sets. Cache keeps its
last input and a score as op state (``forward_with_state``), on the path
BatchNorm's running statistics take.
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op


def expert_capacity(batch: int, k: int, n_experts: int, alpha: float) -> int:
    return max(1, int(math.ceil(alpha * k * batch / n_experts)))


def one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``index`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row (``jax.nn.one_hot``'s rule)."""
    return (index[..., None] == torch.arange(
        n, device=index.device, dtype=index.dtype)).float()


def load_balance_loss(assign: torch.Tensor, gate: torch.Tensor,
                      n_experts: int, lambda_bal: float) -> torch.Tensor:
    """``lambda * E * <f, P>``: f each expert's share of the tokens over
    all top-k slots, P the mean router probability. assign [B, K] int, gate
    [B, E]."""
    f = one_hot(assign, n_experts).mean(dim=(0, 1))
    p_mean = gate.float().mean(dim=0)
    return lambda_bal * n_experts * torch.sum(f * p_mean)


def make_dispatch_tensors(assign: torch.Tensor, gates: torch.Tensor,
                          n_experts: int, capacity: int):
    """assign [B, K] int, gates [B, K] -> (dispatch, combine), each
    [B, K, E, C] f32: dispatch one where token b's slot k takes position c
    of expert e, combine that times the slot's gate. Positions count over
    the flattened ``[B*K, E]`` assignment in token-major, then slot, order;
    the overflow is dropped."""
    b, k = assign.shape
    expert_onehot = one_hot(assign, n_experts)  # [B, K, E]
    flat = expert_onehot.reshape(b * k, n_experts)
    pos = torch.cumsum(flat, dim=0) * flat - flat  # [B*K, E], 0-based
    pos = pos.reshape(b, k, n_experts)
    in_cap = pos < capacity
    pos_onehot = one_hot(pos.to(torch.int32), capacity)
    dispatch = expert_onehot[..., None] * pos_onehot * in_cap[..., None]
    combine = dispatch * gates[..., None, None]
    return dispatch, combine


@register_op(OperatorType.GROUP_BY)
class GroupBy(Op):
    """inputs: (data [B, D], assign [B, K]) -> n_experts tensors [C, D],
    each expert's capacity buffer (overflowed tokens dropped)."""

    def __init__(self, layer, input_shapes):
        self.n_experts = layer.get_property("n")
        self.alpha = layer.get_property("alpha", 1.0)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        data, assign = self.input_shapes
        b, k = assign
        cap = expert_capacity(b, k, self.n_experts, self.alpha)
        return [(cap, data[-1])] * self.n_experts

    def forward(self, params, inputs, ctx: OpContext):
        data, assign = inputs
        b, k = assign.shape
        cap = expert_capacity(b, k, self.n_experts, self.alpha)
        dispatch, _ = make_dispatch_tensors(
            assign, torch.ones(assign.shape, device=assign.device),
            self.n_experts, cap)
        grouped = torch.einsum("bd,bkec->ecd", data.float(), dispatch)
        return [grouped[e].to(data.dtype) for e in range(self.n_experts)]

    def output_dim_roles(self):
        return [(DimRole.OTHER, DimRole.CHANNEL)] * self.n_experts


@register_op(OperatorType.AGGREGATE)
class Aggregate(Op):
    """inputs: (gate_preds [B, K], gate_assign [B, K], true_gate_assign
    [B, K], gate_grads [B, K] (or the full gate [B, E]), expert_out_0
    [C, D] ... expert_out_{n-1}) -> [B, D]: the reference's 4 + n input
    signature. The load-balance loss comes out beside the output when
    ``lambda_bal > 0`` and ``inputs[3]`` is the gate (the moe sugar)."""

    def __init__(self, layer, input_shapes):
        self.n_experts = layer.get_property("n")
        self.lambda_bal = layer.get_property("lambda_bal", 0.0)
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        b, k = self.input_shapes[0]
        d = self.input_shapes[-1][-1]
        return [(b, d)]

    def forward(self, params, inputs, ctx: OpContext):
        return self.forward_with_aux(params, inputs, ctx)[0]

    def forward_with_aux(self, params, inputs, ctx: OpContext):
        """-> (outputs, the load-balance loss or None)."""
        gate_preds, gate_assign = inputs[0], inputs[1]
        expert_outs = inputs[-self.n_experts:]
        cap = expert_outs[0].shape[0]
        _, combine = make_dispatch_tensors(
            gate_assign, gate_preds.float(), self.n_experts, cap)
        stacked = torch.stack(expert_outs, dim=0).float()  # [E, C, D]
        out = torch.einsum("bkec,ecd->bd", combine, stacked)
        aux = None
        if self.lambda_bal > 0.0 and len(inputs) >= 4 + self.n_experts:
            aux = load_balance_loss(gate_assign, inputs[3], self.n_experts,
                                    self.lambda_bal)
        return [out.to(expert_outs[0].dtype)], aux

    def output_dim_roles(self):
        return [(DimRole.SAMPLE, DimRole.CHANNEL)]


@register_op(OperatorType.AGGREGATE_SPEC)
class AggregateSpec(Aggregate):
    """Speculative aggregate: the experts received all K assignments; the
    combine and its output are Aggregate's."""


@register_op(OperatorType.CACHE)
class Cache(Op):
    """Keeps its input across iterations as op state ``{"cached",
    "score"}`` (f32): the output is the input; with state the step moves
    it to this input and its score against the cached one, ``score_fn(
    cached, x)`` (default the mean squared difference). The train step
    keeps the moved state; eval and forward read and drop it, as the
    JAX package's steps do."""

    def __init__(self, layer, input_shapes):
        self.num_batches = layer.get_property("num_batches", 1)
        self.score_fn = layer.get_property("score_fn")
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        return [self.input_shapes[0]]

    def init_state(self, device):
        return {"cached": torch.zeros(self.input_shapes[0], device=device),
                "score": torch.zeros((), device=device)}

    def forward(self, params, inputs, ctx: OpContext, state=None):
        return self.forward_with_state(params, inputs, ctx, state)[0]

    def forward_with_state(self, params, inputs, ctx: OpContext, state):
        """-> (outputs, the new state, or None without state)."""
        (x,) = inputs
        if state is None:
            return [x], None
        seen = x.detach().float()  # the state stays f32 under bf16
        score = (self.score_fn(state["cached"], seen)
                 if self.score_fn is not None
                 else torch.mean((state["cached"] - seen) ** 2))
        return [x], {"cached": seen, "score": score}
