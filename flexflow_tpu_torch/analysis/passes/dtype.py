"""dtype-policy: the bf16 master-weight regime's f32 islands.

PyTorch counterpart of ``flexflow_tpu/analysis/passes/dtype.py``: the
same rules and messages, with the JAX package's jaxpr trace replaced by a
trace of the op's forward under a ``TorchDispatchMode``.

Under mixed precision the executor feeds every op bf16 working copies
of the parameters and bf16 activations; the regime is only numerically
safe because specific computations deliberately upcast: normalization
statistics (a bf16 variance loses most of its mantissa), loss math, and
metric accumulation. This pass verifies those islands statically by
running each norm-family op's training forward on bf16 ``meta`` tensors
(shapes and dtypes only: no device work, no data) and recording every
aten op it dispatches:

* FFL401  a norm op (BatchNorm/GroupNorm/LayerNorm/RMSNorm) accumulates
          a statistics reduction in a 16-bit dtype: an additive aten
          reduction (``sum``, ``mean``, ``var``, ``var_mean``, ``std``,
          ...) whose OUTPUT is bf16/f16. In torch such a reduction still
          accumulates in f32 inside the kernel, but its result is
          rounded to 16 bits before the statistic is used — the
          counterpart of the JAX rule, which fires on a reduce whose
          output aval is 16-bit. ``x.float()`` before the reduction (what
          the shipped norms do) keeps the statistics f32 and the op
          clean; max/min reductions are exact in any dtype and never
          fire;
* FFL402  a norm's statistics VALUES are 16-bit where they are applied
          or stored (new-state leaves non-f32) — the EMA accumulates
          rounding step after step and the normalize subtracts a mean
          that lost 2^-8 of relative precision;
* FFL403  loss/metric accumulation poisoned at the graph level: an
          explicit CAST to a 16-bit dtype feeds the designated model
          output (the loss would compute on truncated logits) or a
          large reduction (low-precision accumulation).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from flexflow_tpu_torch.analysis.diagnostics import Diagnostic, error, warning
from flexflow_tpu_torch.ffconst import DataType, OperatorType

_NORM_OPS = {OperatorType.BATCHNORM, OperatorType.GROUPNORM,
             OperatorType.LAYERNORM, OperatorType.RMSNORM}
_LOW_PRECISION = {DataType.HALF, DataType.BFLOAT16}
_REDUCE_OPS = {OperatorType.REDUCE_SUM, OperatorType.MEAN}
# reductions this small are epilogue math, not accumulation
_MIN_REDUCED_ELEMS = 1024
_LOW_TORCH = (torch.bfloat16, torch.float16)
# the additive aten reductions (overload packets, by name): their result
# carries the accumulation, so a 16-bit output is a 16-bit statistic
_ADDITIVE_REDUCTIONS = frozenset({
    "sum", "mean", "nansum", "nanmean", "var", "var_mean", "std",
    "std_mean", "prod", "linalg_vector_norm", "norm", "logsumexp",
})


class _ReductionDtypes(TorchDispatchMode):
    """Records the output dtypes of every additive aten reduction the
    traced forward dispatches."""

    def __init__(self):
        super().__init__()
        self.low = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in _ADDITIVE_REDUCTIONS:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            if any(isinstance(t, torch.Tensor) and t.dtype in _LOW_TORCH
                   for t in outs):
                self.low = True
        return out


def _trace_norm(op):
    """Trace the op's training forward under the bf16 regime on ``meta``
    tensors. Returns (bad_reduce, new_state_dtypes) — bad_reduce is True
    when an additive reduction in the forward has a 16-bit output,
    new_state_dtypes maps state keys to result dtypes for stateful ops
    (None otherwise)."""
    from flexflow_tpu_torch.ops.base import OpContext

    meta = torch.device("meta")
    params = {k: torch.empty(tuple(s), dtype=torch.bfloat16, device=meta)
              for k, s in op.param_shapes().items()}
    state = op.init_state(meta) if hasattr(op, "init_state") else None
    shp = op.input_shapes[0]
    if getattr(op, "exec_layout", "NCHW") == "NHWC" and len(shp) == 4:
        x = torch.empty(tuple(shp), dtype=torch.bfloat16, device=meta,
                        memory_format=torch.channels_last)
    else:
        x = torch.empty(tuple(shp), dtype=torch.bfloat16, device=meta)
    ctx = OpContext(training=True, compute_dtype=torch.bfloat16,
                    device=meta)
    mode = _ReductionDtypes()
    with torch.no_grad(), mode:
        if state is not None and hasattr(op, "forward_with_state"):
            _, new_state = op.forward_with_state(params, [x], ctx, state)
        else:
            op.forward(params, [x], ctx)
            new_state = None
    ns_dtypes = None
    if new_state is not None:
        ns_dtypes = {k: v.dtype for k, v in new_state.items()}
    return mode.low, ns_dtypes


class DtypePolicyPass:
    name = "dtype-policy"

    def run(self, ctx) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        seen: Dict = {}
        for node in ctx.nodes:
            op = node.op
            if op.op_type in _NORM_OPS:
                key = op.param_key()
                if key in seen:
                    verdict = seen[key]
                else:
                    try:
                        verdict = _trace_norm(op)
                    except Exception:
                        verdict = None  # untraceable: covered by runtime
                    seen[key] = verdict
                if verdict is None:
                    continue
                bad_reduce, ns_dtypes = verdict
                if bad_reduce:
                    diags.append(error(
                        "FFL401",
                        f"{op.op_type.name} accumulates a statistics "
                        f"reduction in a 16-bit dtype",
                        op=op.name, guid=op.guid,
                        hint="upcast before the mean/var reduction "
                             "(x.astype(f32)); a bf16 accumulator loses "
                             "most of its mantissa"))
                for k, dt in (ns_dtypes or {}).items():
                    if dt.is_floating_point and dt != torch.float32:
                        diags.append(error(
                            "FFL402",
                            f"running statistic {k!r} accumulates in "
                            f"{_dtype_name(dt)}",
                            op=op.name, guid=op.guid, tensor=k,
                            hint="EMA state must stay f32 — per-step "
                                 "rounding compounds over training"))
            diags.extend(self._cast_audit(node, ctx))
        return diags

    # ---- FFL403 ------------------------------------------------------------
    def _cast_audit(self, node, ctx) -> List[Diagnostic]:
        op = node.op
        if op.op_type != OperatorType.CAST \
                or op.dtype not in _LOW_PRECISION:
            return []
        diags: List[Diagnostic] = []
        if ctx.final_ref is not None and op.guid == ctx.final_ref[0]:
            diags.append(error(
                "FFL403",
                f"designated model output is a cast to {op.dtype.value} "
                f"— loss/metrics would compute on truncated logits",
                op=op.name, guid=op.guid,
                hint="the loss path upcasts internally but a 16-bit "
                     "output has already lost the mantissa; drop the "
                     "cast or move it off the loss path"))
        for cnode, _ in ctx.consumers().get((op.guid, 0), []):
            if cnode.op.op_type in _REDUCE_OPS:
                axes = cnode.op.layer.get_property("axes", ())
                shp = cnode.op.input_shapes[0]
                reduced = int(np.prod(
                    [shp[a % len(shp)] for a in axes])) if axes else 1
                if reduced >= _MIN_REDUCED_ELEMS:
                    diags.append(warning(
                        "FFL403",
                        f"{cnode.op.op_type.name} accumulates "
                        f"{reduced} elements in {op.dtype.value}",
                        op=cnode.op.name, guid=cnode.op.guid,
                        hint="sum in f32 and cast after — bf16 "
                             "accumulation plateaus once the running "
                             "sum dwarfs the addend"))
        return diags


def _dtype_name(dt: torch.dtype) -> str:
    """numpy's name of a torch float dtype ("bfloat16", "float16"), the
    name the JAX package's message carries."""
    return str(dt).rsplit(".", 1)[-1]
