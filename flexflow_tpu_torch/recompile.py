"""Dynamic recompilation: mutate the model mid-training on a trigger.

PyTorch counterpart of ``flexflow_tpu/recompile.py`` (the reference's
RecompileState, include/flexflow/recompile.h:26, and
FFModel::recompile_on_condition, src/runtime/model.cc:2422-2426). Here
"recompile" means: alter layer properties, rerun ``compile()``, which
builds a new executor (the old one's CUDA graphs and memory pool go with
it), and carry the old parameters over where names and shapes still
match, through ``set_parameter``. The optimizer state starts afresh, as
in the reference.
"""

from __future__ import annotations

from typing import Callable


class RecompileState:
    """trigger_func() -> bool decides; alter_func(ff) mutates layer
    properties; both run between iterations (recompile.h:26 semantics)."""

    def __init__(self, trigger_func: Callable[[], bool],
                 alter_func: Callable[..., None], ffmodel=None):
        self.trigger_func = trigger_func
        self.alter_func = alter_func
        self.ffmodel = ffmodel
        self.recompilations = 0

    def trigger(self) -> bool:
        return bool(self.trigger_func())

    def alter(self) -> None:
        self.alter_func(self.ffmodel)
        self.recompilations += 1


def recompile_on_condition(ffmodel, state: RecompileState) -> bool:
    """If the trigger fires: keep the parameters, alter, re-compile,
    restore the parameters whose (name, shape) survived. Returns True
    when a recompile happened."""
    if not state.trigger():
        return False
    from flexflow_tpu_torch.ffconst import OperatorType
    from flexflow_tpu_torch.model import host_copy
    from flexflow_tpu_torch.ops import OpRegistry

    old_params = {op: {pn: host_copy(t, t.dtype) for pn, t in sub.items()}
                  for op, sub in ffmodel.params.items()}
    state.ffmodel = ffmodel
    state.alter()
    # re-derive tensor shapes through the altered layer list (alter_func
    # may have changed properties that move downstream shapes)
    for layer in ffmodel.layers:
        if layer.op_type == OperatorType.INPUT:
            continue
        op = OpRegistry.create(layer, [t.shape for t in layer.inputs])
        for t, s in zip(layer.outputs, op.output_shapes):
            t.shape = tuple(s)
    iters_so_far = ffmodel._iter
    ffmodel.compile(ffmodel.optimizer, ffmodel.loss_type,
                    list(ffmodel.metrics),
                    comp_mode=ffmodel.config.computation_mode,
                    machine_spec=ffmodel.machine_spec,
                    mesh=ffmodel.mesh)  # keep the live mesh (and its axes)
    ffmodel._iter = iters_so_far  # compile() zeroes it; training continues
    for lname, sub in old_params.items():
        if lname not in ffmodel.params:
            continue
        for pname, arr in sub.items():
            live = ffmodel.params[lname].get(pname)
            if live is not None and tuple(live.shape) == arr.shape:
                ffmodel.set_parameter(lname, arr, pname)
    return True
