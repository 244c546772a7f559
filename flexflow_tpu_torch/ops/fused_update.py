"""Fused optimizer update: the ``_k:fused`` kernel choice.

PyTorch counterpart of ``flexflow_tpu/ops/fused_update.py``. An op whose
strategy choice carries ``_k:fused`` updates its leaves through one fused
pass instead of the optimizer's leaf-by-leaf tensor ops:

* **Adam**: the CUDA kernel ``csrc/fused_adam.cu``, one multi-tensor
  launch per step over every fused leaf (``fused_adam_multi``). It reads
  p, g, m, v once and writes p, m, v once, in place.
* **SGD**: the JAX package has no kernel for it (an XLA
  ``optimization_barrier`` region); here it is the same math in plain
  PyTorch.

Both evaluate EXACTLY the optimizers' expression, operand order included,
so the fused update is bit-equal to ``optimizer.update`` on the same
leaves: the choice moves launches, never values. An unknown optimizer
class takes the whole-tree ``optimizer.update``.

Under weight-update sharding the leaves are each rank's master shards,
their gradients the reduce-scattered shards and their moments the
shards' (``executor.py``): the leaf table is built from those pointers
and sizes, and a leaf the kernel cannot take (dtype, contiguity,
device) raises as any other would.

``fused_adam_multi`` on CUDA tensors launches the kernel or raises; on CPU
tensors it runs ``fused_adam_reference``, the plain version, which is also
what the card's kernel is held against. ``fused_adam_multi.launches``
counts kernel launches (CUDA only; a CUDA-graph capture launches nothing
and a replay adds the graph's nodes of the kernel, ``step_graph.py``).
The launch is capturable into a CUDA graph: its leaf table lives on the
device, one for each set of leaves, and a capture's table is reserved
before it, filled after it and held by its graph (``_LeafTables``).
"""

from __future__ import annotations

import ctypes
import re
from typing import Dict, List, Sequence, Set, Tuple

import torch

from flexflow_tpu_torch import cuda_build
from flexflow_tpu_torch.step_graph import (register_capture_hook,
                                           register_launch_counter)

# the kernel's gradient and state dtypes (its parameters are f32)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _adam_math(p, g, m, v, alpha_t, *, beta1, beta2, eps, wd):
    """One leaf's Adam step (``AdamOptimizer.update`` runs it too) — the
    EXACT expression and order of the JAX package's ``_adam_math``; any
    edit must change ``csrc/fused_adam.cu`` too."""
    sdt = m.dtype
    g = g.to(p.dtype) + wd * p
    m_new = beta1 * m.to(p.dtype) + (1 - beta1) * g
    v_new = beta2 * v.to(p.dtype) + (1 - beta2) * g * g
    p_new = p - alpha_t * m_new / (torch.sqrt(v_new) + eps)
    return p_new, m_new.to(sdt), v_new.to(sdt)


def fused_adam_reference(params, grads, ms, vs, alpha_t, *, beta1, beta2, eps,
                         wd) -> List[Tuple[torch.Tensor, ...]]:
    """Plain version: ``_adam_math`` leaf by leaf -> [(p', m', v')]."""
    return [_adam_math(p, g, m, v, alpha_t, beta1=beta1, beta2=beta2,
                       eps=eps, wd=wd)
            for p, g, m, v in zip(params, grads, ms, vs)]


def _check_leaves(params, grads, ms, vs) -> None:
    n = len(params)
    if not (len(grads) == len(ms) == len(vs) == n):
        raise ValueError(f"fused_adam_multi: {n} params, {len(grads)} grads, "
                         f"{len(ms)} m, {len(vs)} v")
    dev = params[0].device
    gdt, sdt = grads[0].dtype, ms[0].dtype
    if gdt not in KERNEL_DTYPES or sdt not in KERNEL_DTYPES:
        raise ValueError(f"fused_adam_multi: grad dtype {gdt} / state dtype "
                         f"{sdt} not supported (each one of {KERNEL_DTYPES})")
    for i, (p, g, m, v) in enumerate(zip(params, grads, ms, vs)):
        if p.dtype != torch.float32 or g.dtype != gdt or m.dtype != sdt \
                or v.dtype != sdt:
            raise ValueError(f"fused_adam_multi: leaf {i} has dtypes "
                             f"{p.dtype}, {g.dtype}, {m.dtype}, {v.dtype}; "
                             f"the launch takes f32 params, {gdt} grads and "
                             f"{sdt} state for every leaf")
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"fused_adam_multi: leaf {i} shapes differ")
        if any(x.device != dev or not x.is_contiguous() for x in (p, g, m, v)):
            raise ValueError(f"fused_adam_multi: leaf {i} is not contiguous "
                             f"on {dev}")


def fused_adam_multi(params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                     alpha_t: torch.Tensor, *, beta1: float, beta2: float,
                     eps: float, wd: float) -> None:
    """One Adam step over every leaf, in place on ``params``, ``ms`` and
    ``vs`` (p f32; g, m, v f32 or bf16). ``alpha_t`` is the f32 scalar
    tensor of the step. CUDA tensors: one kernel launch for all leaves.
    CPU tensors: the plain version, copied into place."""
    if not params:
        return
    if params[0].device.type == "cpu":
        with torch.no_grad():
            for (p, m, v), new in zip(
                    zip(params, ms, vs),
                    fused_adam_reference(params, grads, ms, vs, alpha_t,
                                         beta1=beta1, beta2=beta2, eps=eps,
                                         wd=wd)):
                p.copy_(new[0])
                m.copy_(new[1])
                v.copy_(new[2])
        return
    if params[0].device.type != "cuda":
        raise ValueError(f"fused_adam_multi: no kernel for device "
                         f"{params[0].device}")
    _check_leaves(params, grads, ms, vs)
    dev = params[0].device
    if (alpha_t.device != dev or alpha_t.dtype != torch.float32
            or alpha_t.numel() != 1):
        raise ValueError("fused_adam_multi: alpha_t must be one f32 value on "
                         f"{dev}")
    lib = cuda_build.load("fused_adam")
    fn = lib.ff_fused_adam
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_void_p] + [ctypes.c_float] * 6
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ff_fused_adam_chunk.restype = ctypes.c_int
    chunk = lib.ff_fused_adam_chunk()
    rows, n_chunks = [], 0
    for p, g, m, v in zip(params, grads, ms, vs):
        if p.numel():
            rows.append((p.data_ptr(), g.data_ptr(), m.data_ptr(),
                         v.data_ptr(), p.numel(), n_chunks))
            n_chunks += -(-p.numel() // chunk)
    if not rows:
        return
    table = _LEAF_TABLES.get(rows, dev)
    with torch.cuda.device(dev):
        rc = fn(table.data_ptr(), len(rows), n_chunks, alpha_t.data_ptr(),
                beta1, 1 - beta1, beta2, 1 - beta2, eps, wd,
                int(grads[0].dtype == torch.bfloat16),
                int(ms[0].dtype == torch.bfloat16),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {rc} "
                           f"({len(rows)} leaves, {n_chunks} chunks)")
    if not torch.cuda.is_current_stream_capturing():
        fused_adam_multi.launches += 1


fused_adam_multi.launches = 0


class _LeafTables:
    """The kernel's leaf tables on the device, one for each set of leaves
    (the table is a function of its rows: the leaves' pointers, sizes and
    first chunks), so that a step whose leaves keep their storage uploads
    its table once; eager calls keep their ``EAGER_TABLES`` most recent.
    A CUDA graph cannot take a table made inside its own capture: a copy
    recorded into the graph would read a host buffer freed before the
    first replay, and memory allocated inside the capture is the graph's,
    which its earlier nodes rewrite on every replay. So each eager call
    also reserves a spare table of its size, a capture takes the spare of
    its size, and ``end_capture`` fills it once the capture has ended and
    hands it to the graph, which holds it as long as the graph lives."""

    EAGER_TABLES = 4

    def __init__(self):
        self._tables: Dict[tuple, torch.Tensor] = {}
        self._spares: Dict[tuple, torch.Tensor] = {}
        # (table, its rows on the host) taken by the capture under way
        self._taken: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def get(self, rows, dev: torch.device) -> torch.Tensor:
        size = (dev, len(rows))
        if torch.cuda.is_current_stream_capturing():
            table = self._spares.pop(size, None)
            if table is None:
                raise RuntimeError(
                    f"fused_adam_multi: no leaf table of {len(rows)} rows "
                    f"reserved for this CUDA-graph capture: run the update "
                    f"once outside the capture first")
            self._taken.append((table, torch.tensor(rows, dtype=torch.int64)))
            return table
        key = (dev, tuple(rows))
        table = self._tables.pop(key, None)  # re-inserted as the newest
        if table is None:
            # up with the step's other work: pinned, asynchronous
            table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
                dev, non_blocking=True)
        self._tables[key] = table
        for k in list(self._tables)[:-self.EAGER_TABLES]:
            del self._tables[k]
        if size not in self._spares:
            self._spares[size] = torch.empty_like(table)
        return table

    def end_capture(self, discard: bool) -> List[torch.Tensor]:
        """After a capture: fill the tables it took and return them (for
        its graph to hold); with ``discard`` (it failed), drop them."""
        taken, self._taken = self._taken, []
        if discard:
            return []
        for table, host in taken:
            table.copy_(host)
        return [table for table, _ in taken]


_LEAF_TABLES = _LeafTables()
register_capture_hook(_LEAF_TABLES.end_capture)
register_launch_counter(fused_adam_multi, "launches",
                        re.compile(r"(?<![A-Za-z_])fused_adam(<|I)").search)


def _sgd_math(opt, p, g, v):
    """One leaf's SGD step, momentum form (``SGDOptimizer.update`` runs it
    too)."""
    g = g + opt.weight_decay * p
    v_new = opt.momentum * v + g
    upd = g + opt.momentum * v_new if opt.nesterov else v_new
    return p - opt.lr * upd, v_new


def _subtree(tree: Dict, names) -> Dict:
    return {k: tree[k] for k in names}


def _ordered(tree: Dict, like: Dict) -> Dict:
    """``tree`` with the op order of ``like`` (the parameter tree)."""
    return {k: tree[k] for k in like}


def fused_optimizer_update(opt, grads, state, params,
                           fused_ops: Set[str]) -> Tuple[Dict, Dict]:
    """``optimizer.update`` with the ``fused_ops`` subtrees routed through
    the fused pass; value-identical to the plain update (same math, same
    order). The fused Adam leaves update in place (the kernel writes p, m,
    v where they lie); the rest go through ``opt.update``."""
    from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer

    fused = [k for k in params if k in fused_ops]
    rest = [k for k in params if k not in fused_ops]

    if isinstance(opt, AdamOptimizer):
        t, alpha_t = opt.step_scalars(state["t"])
        new_p, new_m, new_v = {}, {}, {}
        if rest:
            # the complement through the plain update (no duplicated math
            # to drift); its t advance equals ours
            rp, rs = opt.update(_subtree(grads, rest), dict(
                m=_subtree(state["m"], rest), v=_subtree(state["v"], rest),
                t=state["t"]), _subtree(params, rest))
            new_p.update(rp)
            new_m.update(rs["m"])
            new_v.update(rs["v"])
        leaves = [(op, pn) for op in fused for pn in params[op]]
        fused_adam_multi(
            [params[op][pn] for op, pn in leaves],
            [grads[op][pn] for op, pn in leaves],
            [state["m"][op][pn] for op, pn in leaves],
            [state["v"][op][pn] for op, pn in leaves],
            alpha_t, beta1=opt.beta1, beta2=opt.beta2, eps=opt.epsilon,
            wd=opt.weight_decay)
        for op in fused:
            new_p[op] = params[op]
            new_m[op] = state["m"][op]
            new_v[op] = state["v"][op]
        return _ordered(new_p, params), {"m": _ordered(new_m, params),
                                         "v": _ordered(new_v, params), "t": t}

    if isinstance(opt, SGDOptimizer):
        new_p = {}
        if opt.momentum == 0.0:
            if rest:
                new_p.update(opt.update(_subtree(grads, rest), state,
                                        _subtree(params, rest))[0])
            for op in fused:
                new_p[op] = {pn: p - opt.lr * (grads[op][pn]
                                               + opt.weight_decay * p)
                             for pn, p in params[op].items()}
            return _ordered(new_p, params), state
        new_v = {}
        if rest:
            rp, rs = opt.update(_subtree(grads, rest),
                                dict(v=_subtree(state["v"], rest)),
                                _subtree(params, rest))
            new_p.update(rp)
            new_v.update(rs["v"])
        for op in fused:
            sp, sv = {}, {}
            for pn, p in params[op].items():
                sp[pn], sv[pn] = _sgd_math(opt, p, grads[op][pn],
                                           state["v"][op][pn])
            new_p[op] = sp
            new_v[op] = sv
        return _ordered(new_p, params), {"v": _ordered(new_v, params)}

    # unknown optimizer class: no math to mirror — the whole-tree update
    return opt.update(grads, state, params)
