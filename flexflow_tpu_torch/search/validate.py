"""Priced-vs-emitted validation: collectives and memory.

The port's counterpart of ``flexflow_tpu/search/validate.py``. The native
simulator prices a set of collectives for a strategy; the step emits its
own. This module gives both sides so tests can assert they agree.

- Priced side: ``simulate_strategy`` replays the compiled strategy
  through the port's native simulator (``search/native.py``
  ``native_simulate``), whose tasks carry (collective, bytes);
  ``priced_collectives`` sums them by kind.
- Emitted side: ``emitted_collectives`` normalizes a step's collective
  census (``obs/inspect.py``: NCCL calls) onto the simulator's
  vocabulary. The port runs one card: its census is ``{}``.
- Memory: ``predicted_vs_actual_memory`` puts the search's
  ``predicted_memory`` beside the train step's measured footprint
  (``obs/inspect.py``: the allocator's peak over the replayed steps of
  a traced ``fit``, with the CUDA-graph pool that holds a replay's
  activations).

The JAX package's ``compiled_train_step``, ``train_step_hlo`` and
``compiled_footprint_bytes`` lower an XLA program; a CUDA-graph step has
no such program, and they have no counterpart here.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List

from flexflow_tpu_torch.obs.inspect import PRICED_MIN_BYTES

# kind normalization: census kind -> the simulator's collective vocabulary
_HLO_KINDS = {
    "all-reduce": "allreduce",
    "reduce-scatter": "allreduce",      # ar decomposition half
    "all-gather": "allgather",
    "collective-permute": "ppermute",
    "all-to-all": "reshard",
}

# which priced kinds cover an emitted kind (the JAX package's table)
COLLECTIVE_COVER = {
    "allreduce": {"allreduce"},
    "allgather": {"allgather", "reshard", "allreduce"},
    "ppermute": {"ppermute", "reshard"},
    "reshard": {"reshard", "allgather", "ppermute"},
}


def emitted_collectives(census: Dict[str, Dict[str, float]],
                        min_bytes: float = PRICED_MIN_BYTES
                        ) -> Dict[str, float]:
    """Collective kind -> summed payload bytes of a step's census
    (``{kind: {count, bytes}}``), on the simulator's vocabulary; kinds
    whose bytes fall under ``min_bytes`` are left out."""
    out: Dict[str, float] = defaultdict(float)
    for kind, entry in (census or {}).items():
        if entry["bytes"] < min_bytes:
            continue
        out[_HLO_KINDS.get(kind, kind)] += entry["bytes"]
    return dict(out)


def predicted_vs_actual_memory(ff) -> Dict[str, float]:
    """Search-predicted per-device memory vs the train step's measured
    footprint: arguments and activations, as the prediction counts them
    (``inspect_compiled``'s ``footprint_bytes``). Needs a search-compiled
    model (``search_budget`` > 0, so ``search_info["predicted_memory"]``
    exists) that ran a traced ``fit`` on the card (the peak is read
    around its replayed steps)."""
    from flexflow_tpu_torch.obs.inspect import inspect_compiled

    info = ff.search_info if isinstance(ff.search_info, dict) else {}
    predicted = info.get("predicted_memory")
    if not predicted:
        raise ValueError(
            "predicted_vs_actual_memory needs a search-compiled model "
            "(set search_budget so predicted_memory is recorded)")
    actual = inspect_compiled(ff)["memory"]["footprint_bytes"]
    if actual is None:
        raise ValueError(
            "predicted_vs_actual_memory needs the train step's measured "
            "peak and its graph pool: run fit(trace_dir=...) on the card "
            "first")
    return dict(predicted=float(predicted), actual=float(actual),
                ratio=float(actual) / float(predicted))


def simulate_strategy(ff, learned: Any = "auto") -> Dict[str, Any]:
    """Replay the strategy ``FFModel.compile`` selected through the
    native simulator; returns the full response: iteration_time, memory,
    the fwd/bwd/comm/gradsync breakdown, the scheduled task list
    (per-task start/finish seconds and collective census records), which
    ``obs/simtrace.py`` renders as the predicted Perfetto lanes, and
    ``cost_sources`` (which model priced each op).

    ``learned``: "auto" prices with the table the search found for the
    model's device (``costmodel.load_native_table``), so that the replay
    matches the search; False prices analytically (the control arm of
    the learned-against-analytic comparison); a native-table dict prices
    with that table."""
    from flexflow_tpu_torch.search.native import native_simulate
    from flexflow_tpu_torch.search.unity import (machine_to_json,
                                                 serialize_graph)

    if learned == "auto":
        # a table that fails to load prices analytically, as the search
        # does
        try:
            from flexflow_tpu_torch.costmodel import load_native_table
            learned = load_native_table(device=ff.device)
        except Exception:
            learned = None
    elif not learned:
        learned = None

    nodes = ff.executor.nodes
    axes = dict(ff.mesh.shape)
    if axes.get("pipe", 1) > 1:
        raise NotImplementedError(
            "replaying a 'pipe' mesh: pipeline execution is ROADMAP.md "
            "Queue 1 item 10")
    wus_on = bool(getattr(ff.executor, "weight_update_sharding", False))
    wus_ops = getattr(ff.executor, "wus_ops", None)
    ovl_on = bool(getattr(ff.executor, "grad_overlap", False))
    kc = getattr(ff.executor, "kernel_choices", None) or {}
    assignment = {}
    for node in nodes:
        st = (ff.strategy or {}).get(node.op.guid)
        choice = getattr(st, "choice", None)
        if choice is None:
            choice = _infer_choice(node, st)
        # replay what the executor executes (canonical order
        # base[_wus][_ovl][_k:impl]): the "_k:<impl>" suffix survives
        # exactly when the executor runs that impl
        base = choice
        ksfx = ""
        if "_k:" in base:
            base, _, kimpl = base.partition("_k:")
            ksfx = "_k:" + kimpl
        for sfx in ("_ovl", "_wus"):
            base = base.replace(sfx, "")
        choice = base
        op_wus = (wus_on and node.op.params_elems()
                  and (wus_ops is None or node.op.name in wus_ops))
        if op_wus:
            choice += "_wus"
            if ovl_on:
                choice += "_ovl"
        if ksfx and kc.get(node.op.name) == ksfx[3:]:
            choice += ksfx
        assignment[str(node.op.guid)] = choice
    req = dict(
        nodes=serialize_graph(nodes, final_guid=ff.executor.final_ref[0]),
        machine=machine_to_json(ff.machine_spec, ff.mesh.size,
                                learned=learned),
        config=dict(training=True, overlap=True,
                    opt_state_factor=getattr(ff.config, "opt_state_factor",
                                             2.0)),
        mesh={"data": axes.get("data", 1), "model": axes.get("model", 1),
              "seq": axes.get("seq", 1), "expert": axes.get("expert", 1),
              "pipe": axes.get("pipe", 1)},
        assignment=assignment,
        measured={},
    )
    return native_simulate(req)


def priced_collectives(ff, min_bytes: float = 1 << 12) -> Dict[str, float]:
    """Collective kind -> summed bytes the native simulator charged for
    the strategy ``FFModel.compile`` selected."""
    resp = simulate_strategy(ff)
    out: Dict[str, float] = defaultdict(float)
    for t in resp.get("tasks", []):
        if t.get("collective") and t.get("bytes", 0) >= min_bytes:
            out[t["collective"]] += t["bytes"]
    return dict(out)


def _infer_choice(node, st) -> str:
    """Native choice name for a heuristic (non-searched) strategy entry,
    derived from its specs, so that explicit-mesh strategies (ring
    attention over a user mesh) replay through the simulator. Mirrors
    the naming of ``native/ffs_strategy.hpp`` ``enumerate_choices``."""
    from flexflow_tpu_torch.ffconst import OperatorType

    specs = (st.output_specs if st is not None else None) or []
    entries = list(specs[0]) if specs and specs[0] is not None else []
    base = "dp" if entries and entries[0] == "data" else "rep"
    params = (st.param_specs if st is not None else None) or {}
    kspec = params.get("kernel")
    if kspec is not None and "model" in tuple(kspec):
        if node.op.op_type == OperatorType.LINEAR:
            base = "dp_col" if base == "dp" else "col"
    wq = params.get("wq")
    if wq is not None and tuple(wq) and tuple(wq)[0] == "model":
        base = "dp_head" if base == "dp" else "head"
    if "seq" in entries:
        suffix = ("_ring" if node.op.op_type ==
                  OperatorType.MULTIHEAD_ATTENTION else "_sp")
        base += suffix
    return base


def diff_collectives(priced: Dict[str, float], emitted: Dict[str, float],
                     tol_factor: float = 3.0) -> List[str]:
    """Discrepancy report. Empty list = the priced set covers what the
    step emitted (within tol_factor on bytes) and vice versa."""
    problems = []
    cover = COLLECTIVE_COVER
    for kind, eb in emitted.items():
        pb = sum(priced.get(k, 0.0) for k in cover.get(kind, {kind}))
        if pb <= 0:
            problems.append(
                f"the step emitted {kind} ({eb / 1e6:.2f} MB) but the "
                f"simulator priced none")
        elif eb > pb * tol_factor:
            problems.append(
                f"{kind}: emitted {eb / 1e6:.2f} MB vs priced "
                f"{pb / 1e6:.2f} MB (> {tol_factor}x)")
    for kind, pb in priced.items():
        eb = sum(emitted.get(k, 0.0) for k in cover.get(kind, {kind}))
        if eb <= 0 and pb > (1 << 16):
            problems.append(
                f"simulator priced {kind} ({pb / 1e6:.2f} MB) but the "
                f"step emitted none")
    return problems
