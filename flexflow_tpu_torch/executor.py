"""Graph executor: runs the materialized op graph forward, and trains it.

PyTorch counterpart of ``flexflow_tpu/executor.py``'s ``GraphExecutor``.
Where the JAX package traces the graph into one jitted step, the port runs
it eagerly, op by op in topological order, on one device. Values are keyed
by ``(producer guid, output index)`` and inputs are referenced as
``("op", guid, idx)`` / ``("input", name)``, the reference's scheme.

The forward for inference runs under ``torch.inference_mode``. The train
step runs the forward with grad enabled on the compute copy of the
parameters, gets the gradients from autograd (bf16 under the master-weight
regime: the gradients of the bf16 compute copy), updates the f32 master
parameters and the optimizer state, then re-derives the compute copy from
the new parameters: the JAX step's order. Ops whose strategy choice is
``_k:fused`` update through the fused pass (``ops/fused_update.py``).
A mesh reaches the ops through ``OpContext.mesh``: one process runs a
mesh whose one axis above 1 is ring attention's sequence axis, every ring
position on this device. Sharding, remat and multi-step scans come with
later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.ffconst import CompMode, LossType
from flexflow_tpu_torch.losses import get_loss_fn
from flexflow_tpu_torch.ops.base import Op, OpContext

# pseudo-entry in the op-state dict holding the compute-dtype (bf16) copy
# of the parameters under the master-weight mixed-precision regime (never
# collides with op names, which come from Layer naming)
COMPUTE_PARAMS_KEY = "__compute_params__"


class OpNode:
    """One materialized operator + where its inputs come from.

    ``input_refs``: list of ('op', producer_guid, out_idx) or
    ('input', input_name).
    """

    def __init__(self, op: Op, input_refs: List[Tuple]):
        self.op = op
        self.input_refs = input_refs
        # the strategy's specs (parallel/strategy.py apply_strategy): one
        # per output, and one per parameter name
        self.output_specs: List[Optional[Tuple]] = [None] * len(op.output_shapes)
        self.param_specs: Dict[str, Tuple] = {}

    @property
    def guid(self):
        return self.op.guid


class GraphExecutor:
    def __init__(self, nodes: List[OpNode], input_names: List[str], final_ref,
                 device: torch.device,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 loss_type: Optional[LossType] = None, metrics=None,
                 optimizer=None, final_is_softmax: bool = False,
                 kernel_choices: Optional[Dict[str, str]] = None,
                 mesh=None):
        self.nodes = nodes
        self.input_names = input_names
        # (guid, out_idx) of the user-designated model output
        self.final_ref = tuple(final_ref)
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.loss_type = loss_type
        self.metrics = metrics
        self.optimizer = optimizer
        self.final_is_softmax = final_is_softmax
        self.comp_mode = CompMode.TRAINING
        # master-weight regime: the forward reads a compute-dtype copy of
        # the f32 parameters, cast once (at compile, after each train step
        # and after any parameter write) instead of on every call
        self.use_master_copy = compute_dtype != torch.float32
        # per-op kernel implementations from an imported strategy: {op
        # name -> impl}. "fused" routes the op's optimizer update through
        # the fused pass; attention impls ("flash"/"einsum") live on the
        # op itself (MultiHeadAttention.kernel_impl, pinned at compile).
        # None = no kernel choices: every op keeps its default.
        self.kernel_choices = dict(kernel_choices) if kernel_choices else None
        self.fused_update_ops = {
            n for n, impl in (self.kernel_choices or {}).items()
            if impl == "fused"}
        # the compiled mesh (machine.Mesh or None), handed to every op
        self.mesh = mesh

    def _ctx(self, training: bool, rng=None) -> OpContext:
        return OpContext(training=training, compute_dtype=self.compute_dtype,
                         rng=rng, mesh=self.mesh)

    # ---- parameter / state initialization ---------------------------------
    def init_params_and_state(self, generator: torch.Generator
                              ) -> Tuple[Dict, Dict]:
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        state: Dict[str, Any] = {}
        for node in self.nodes:
            ps = node.op.init_params(generator)
            if ps:
                params[node.op.name] = ps
        if self.use_master_copy:
            state[COMPUTE_PARAMS_KEY] = self.cast_compute_copy(params)
        return params, state

    def cast_compute_copy(self, params):
        """Compute-dtype copy of the float parameter leaves (the forward's
        working set under the master-weight regime)."""
        return {op: {pn: (a.to(self.compute_dtype)
                          if a.is_floating_point() else a)
                     for pn, a in sub.items()}
                for op, sub in params.items()}

    # ---- forward graph traversal ------------------------------------------
    def run_graph(self, params, inputs: Dict[str, torch.Tensor],
                  ctx: OpContext) -> Dict[Tuple[int, int], torch.Tensor]:
        """Evaluate ops in topo order; returns every op output keyed by
        (producer guid, output index). (Op state, the auxiliary losses and
        the Conv+BN inference fold of the JAX package come with the ops
        that need them.)"""
        values: Dict[Tuple[int, int], torch.Tensor] = {}
        for node in self.nodes:
            op = node.op
            args = [values[(ref[1], ref[2])] if ref[0] == "op"
                    else inputs[ref[1]] for ref in node.input_refs]
            outs = op.forward(params.get(op.name, {}), args, ctx)
            for i, o in enumerate(outs):
                values[(op.guid, i)] = o
        return values

    def make_forward(self, training: bool = False):
        """``fwd(params, state, inputs) -> output``. Reads the compute copy
        of the parameters when the state carries one. ``training=False``
        runs under ``torch.inference_mode``; ``training=True`` runs the
        training-mode forward with grad enabled (its output carries the
        autograd graph back to the parameters it was given)."""

        def fwd(params, state, inputs, rng=None):
            ctx = self._ctx(training, rng)
            cparams = state.get(COMPUTE_PARAMS_KEY, params)
            if training:
                with torch.enable_grad():
                    return self.run_graph(cparams, inputs, ctx)[self.final_ref]
            with torch.inference_mode():
                return self.run_graph(cparams, inputs, ctx)[self.final_ref]

        return fwd

    # ---- training ----------------------------------------------------------
    def _loss_value(self, logits, labels):
        fn = get_loss_fn(self.loss_type)
        if self.final_is_softmax and self.loss_type in (
            LossType.CATEGORICAL_CROSSENTROPY,
            LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        ):
            # final op already produced probabilities (the reference pairs
            # a Softmax op with CE loss)
            logp = torch.log(torch.clamp(logits.float(), 1e-12, 1.0))
            if self.loss_type == LossType.CATEGORICAL_CROSSENTROPY:
                return -torch.mean(torch.sum(labels * logp, dim=-1))
            lab = labels.reshape(labels.shape[0], -1)[:, 0].long()
            return -torch.mean(torch.gather(logp, -1, lab[:, None]))
        return fn(logits, labels)

    def _optimizer_update(self, grads, opt_state, params):
        """Optimizer update honoring per-op ``_k:fused`` kernel choices:
        the chosen ops' leaves update through the fused pass
        (ops/fused_update.py, bit-equal to the plain update); the rest
        take ``optimizer.update`` unchanged."""
        fused = {n for n in self.fused_update_ops if n in params}
        if not fused:
            return self.optimizer.update(grads, opt_state, params)
        from flexflow_tpu_torch.ops.fused_update import fused_optimizer_update
        return fused_optimizer_update(self.optimizer, grads, opt_state,
                                      params, fused)

    def grads_of(self, params, state, inputs, labels, rng=None):
        """One forward and backward: (loss, logits, grads). ``grads`` has
        the tree of ``params``, in the dtype of the tensors the forward
        read (the compute copy's, under the master-weight regime). The
        leaves the autograd graph starts from are made fresh here, so no
        graph outlives the call."""
        cparams = (state[COMPUTE_PARAMS_KEY] if self.use_master_copy
                   else params)
        leaves = {op: {pn: t.detach().requires_grad_(t.is_floating_point())
                       for pn, t in sub.items()}
                  for op, sub in cparams.items()}
        flat = [(op, pn) for op, sub in leaves.items() for pn, t in sub.items()
                if t.requires_grad]
        ctx = self._ctx(True, rng)
        with torch.enable_grad():
            logits = self.run_graph(leaves, inputs, ctx)[self.final_ref]
            loss = self._loss_value(logits, labels)
            got = torch.autograd.grad(
                loss, [leaves[op][pn] for op, pn in flat], allow_unused=True)
        got = dict(zip(flat, got))
        grads = {op: {pn: (got.get((op, pn)) if got.get((op, pn)) is not None
                           else torch.zeros_like(t))
                      for pn, t in sub.items()}
                 for op, sub in leaves.items()}
        return loss.detach(), logits.detach(), grads

    def _train_step_fn(self):
        """The train step as a plain function:
        ``(params, opt_state, state, inputs, labels, rng) -> (params,
        opt_state, state, loss, metric sums)``."""

        def train_step(params, opt_state, state, inputs, labels, rng=None):
            loss, logits, grads = self.grads_of(params, state, inputs,
                                                labels, rng)
            with torch.no_grad():
                new_params, new_opt_state = self._optimizer_update(
                    grads, opt_state, params)
                new_state = dict(state)
                if self.use_master_copy:
                    # the next step's bf16 working copy
                    new_state[COMPUTE_PARAMS_KEY] = \
                        self.cast_compute_copy(new_params)
                metric_vals = self.metrics.compute(logits, labels)
            return new_params, new_opt_state, new_state, loss, metric_vals

        return train_step

    def make_train_step(self):
        if self.comp_mode == CompMode.INFERENCE:
            raise RuntimeError(
                "model compiled with CompMode.INFERENCE is forward-only; "
                "re-compile with CompMode.TRAINING to train")
        return self._train_step_fn()

    def make_eval_step(self):
        """``eval_step(params, state, inputs, labels) -> (loss, logits,
        metric sums)``, under ``torch.inference_mode``."""

        def eval_step(params, state, inputs, labels):
            ctx = self._ctx(False)
            with torch.inference_mode():
                logits = self.run_graph(state.get(COMPUTE_PARAMS_KEY, params),
                                        inputs, ctx)[self.final_ref]
                loss = self._loss_value(logits, labels)
                return loss, logits, self.metrics.compute(logits, labels)

        return eval_step
