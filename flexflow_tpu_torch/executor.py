"""Graph executor: runs the materialized op graph forward, for inference.

PyTorch counterpart of ``flexflow_tpu/executor.py``'s ``GraphExecutor``.
Where the JAX package traces the graph into one jitted step, the port runs
it eagerly, op by op in topological order, under ``torch.inference_mode``
on one device. Values are keyed by ``(producer guid, output index)`` and
inputs are referenced as ``("op", guid, idx)`` / ``("input", name)``,
the reference's scheme. The training step, the optimizer update, meshes
and sharding come with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

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

    @property
    def guid(self):
        return self.op.guid


class GraphExecutor:
    def __init__(self, nodes: List[OpNode], input_names: List[str], final_ref,
                 device: torch.device,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.nodes = nodes
        self.input_names = input_names
        # (guid, out_idx) of the user-designated model output
        self.final_ref = tuple(final_ref)
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        # master-weight regime: the forward reads a compute-dtype copy of
        # the f32 parameters, cast once (at compile, and again after any
        # parameter write) instead of on every call
        self.use_master_copy = compute_dtype != torch.float32

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
        """``fwd(params, state, inputs) -> output``, run under
        ``torch.inference_mode``. Reads the compute copy of the parameters
        when the state carries one."""
        if training:
            raise NotImplementedError(
                "the training forward comes with the training slice of the "
                "PyTorch port")

        def fwd(params, state, inputs):
            ctx = OpContext(training=False, compute_dtype=self.compute_dtype)
            with torch.inference_mode():
                values = self.run_graph(state.get(COMPUTE_PARAMS_KEY, params),
                                        inputs, ctx)
            return values[self.final_ref]

        return fwd
