"""Compiled-step inspector: the train step's FLOPs, memory and collectives.

The port's counterpart of ``flexflow_tpu/obs/inspect.py``, writing the
same ``.summary.json`` fields. XLA's cost analysis, memory analysis and
optimized HLO text have no torch counterpart, so the fields are filled
from what the port has:

- ``flops``: the ops' analytic forward FLOPs x3 for a train step, the
  convention of ``devtrace.train_step_flops``.
- ``bytes_accessed``, ``transcendentals`` and ``fusions``: null. A CUDA
  graph has no cost analysis, and its kernels are not XLA fusions.
- ``memory``: ``peak_bytes`` is ``torch.cuda.max_memory_allocated()``
  over the replayed steps of the last traced ``fit``, each after
  ``reset_peak_memory_stats()`` (``FFModel._run_epochs``);
  ``argument_bytes`` the live parameters, optimizer state, op state and
  staged batch; ``graph_pool_bytes`` what the compiled steps' CUDA-graph
  pool reserves. A replay allocates nothing: its activations live in
  the pool's free blocks, which the peak does not count, while the
  pool's live blocks (the graphs' outputs) are in it. So
  ``footprint_bytes``, what the step holds on the card, is the peak
  less the pool's live bytes plus its reservation, and ``temp_bytes``
  (the reference's sense: all but the arguments, activations included)
  the footprint less the arguments. A model on the CPU has no device
  allocator: its peak, footprint, temp and pool are null.
- ``collectives``: over a process group, the last train step's record
  of ``parallel/comm.py`` (``MeshComm.census``: each call's kind and
  output bytes, HLO's convention), with ``collectives_source``
  ``"process_group:<backend>"``; on one card ``{}`` with
  ``collectives_source: "nccl"`` (ring attention's hops on one card are
  copies, not collectives). The port issues one collective where GSPMD
  may combine several (XLA's all-reduce combiner) or pick another kind,
  so counts compare with the JAX package's HLO census by kind, not one
  for one.

``collective_census`` and ``census_totals`` read HLO text and census
dicts as the JAX package's do, so that tools holding either package's
census agree.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s32": 4, "u32": 4,
    "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")

# the collective kinds of the census vocabulary (async -start/-done
# pairs count once via the -start op)
COLLECTIVE_KINDS = ("all-reduce", "reduce-scatter", "all-gather",
                    "all-to-all", "collective-permute")

# the payload below which the search's simulator does not price a
# collective (scalar loss/metric reductions); the validator filters with
# it, the summary does not
PRICED_MIN_BYTES = float(1 << 12)

_COLLECTIVE_RE = re.compile(
    r"\b(" + "|".join(COLLECTIVE_KINDS) + r")(-start|-done)?(\.\d+)?\(")


def shape_bytes(shape_str: str) -> float:
    """Total bytes of an HLO shape string like ``f32[128,256]`` or a
    variadic tuple ``(f32[8,4], f32[8,4])``."""
    total = 0.0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_census(hlo_text: str, min_bytes: float = 0.0
                      ) -> Dict[str, Dict[str, float]]:
    """HLO opcode -> {count, bytes} over an optimized module's text; each
    op's OUTPUT shape is its byte volume. Lines read ``%name = SHAPE
    opcode(operands)``; splitting at the first `` = `` keeps LHS names
    like ``%all-reduce.58`` from matching."""
    out: Dict[str, Dict[str, float]] = {}
    for line in hlo_text.splitlines():
        line = line.strip()
        if " = " not in line:
            continue
        rhs = line.split(" = ", 1)[1]
        m = _COLLECTIVE_RE.search(rhs)
        if not m or m.group(2) == "-done":
            continue
        b = shape_bytes(rhs[:m.start()])
        if b < min_bytes:
            continue
        e = out.setdefault(m.group(1), dict(count=0, bytes=0.0))
        e["count"] += 1
        e["bytes"] += b
    return out


def census_totals(census: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    return dict(
        count=sum(e["count"] for e in census.values()),
        bytes=sum(e["bytes"] for e in census.values()),
    )


def _tree_bytes(tree) -> float:
    import torch

    if isinstance(tree, torch.Tensor):
        return float(tree.numel() * tree.element_size())
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0.0


def _graph_pool_segments(ff):
    """The allocator segments of the executor's CUDA-graph memory pool
    (None on the CPU, or before any capture)."""
    import torch

    pool = getattr(ff.executor, "_graph_pool", None)
    if ff.device.type != "cuda" or pool is None:
        return None
    pool = tuple(pool)
    return [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id") or ()) == pool]


def step_footprint_bytes(ff, peak: Optional[float]) -> Optional[float]:
    """What the compiled train step holds on the card: ``peak``, the
    allocator's peak over replayed steps, less the CUDA-graph pool's live
    blocks plus the pool's reservation (a replay's activations live in
    the pool's free blocks, which the peak does not count). None on the
    CPU, before any capture, or without a peak."""
    segs = _graph_pool_segments(ff)
    if peak is None or segs is None:
        return None
    return (peak - sum(seg["allocated_size"] for seg in segs)
            + float(sum(seg["total_size"] for seg in segs)))


def inspect_compiled(ff) -> Dict[str, Any]:
    """FLOPs, memory and collective census of a compiled model's train
    step (see the module docstring for each field's source)."""
    from flexflow_tpu_torch.obs.devtrace import train_step_flops

    feeds = 0.0
    graph = ff.executor.step_graphs.get("train_step")
    for e in (getattr(graph, "_entries", None) or {}).values():
        feeds = max(feeds, _tree_bytes(e.feeds))
    args = (_tree_bytes(ff.params) + _tree_bytes(ff.opt_state)
            + _tree_bytes(ff.state) + feeds)
    peak = getattr(ff, "_step_peak_bytes", None)
    segs = _graph_pool_segments(ff)
    pool = (None if segs is None
            else float(sum(seg["total_size"] for seg in segs)))
    footprint = step_footprint_bytes(ff, peak)
    memory = dict(
        argument_bytes=args,
        peak_bytes=peak,
        footprint_bytes=footprint,
        temp_bytes=(max(footprint - args, 0.0) if footprint is not None
                    else None),
        graph_pool_bytes=pool,
        # the step's staged batch (static feed buffers) within arguments
        feed_bytes=feeds,
    )
    comm = getattr(ff.executor, "_comm", None)
    census: Dict[str, Dict[str, float]] = comm.census() if comm else {}
    return dict(
        flops=train_step_flops(ff),
        bytes_accessed=None,
        transcendentals=None,
        memory=memory,
        collectives=census,
        collectives_total=census_totals(census),
        collectives_min_bytes=0.0,
        collectives_source=(f"process_group:{comm.backend}" if comm
                            else "nccl"),
        fusions=None,
    )


def export_step_summary(ff, tracer) -> Dict[str, Any]:
    """Inspect the train step and write the ``.summary.json`` artifact
    next to the tracer's other files. Returns the summary dict."""
    import os

    from flexflow_tpu_torch.obs.artifacts import write_artifact

    summary = inspect_model_step(ff)
    path = os.path.join(tracer.trace_dir, tracer.file_stem + ".summary.json")
    write_artifact(path, summary, host_id=tracer.host_id,
                   kind="step_summary", device=ff.device,
                   header_extra=dict(run_name=tracer.run_name,
                                     run_seq=tracer.run_seq))
    return summary


def model_context(ff) -> Dict[str, Any]:
    """Graph/mesh context the summary's numbers need, shared by the trace
    header (``FFModel._make_tracer``) and the step summary."""
    return dict(
        num_ops=len(ff.executor.nodes),
        mesh_axes=dict(ff.mesh.shape),
        batch_size=(ff.input_tensors[0].shape[0]
                    if ff.input_tensors else None),
    )


def inspect_model_step(ff) -> Dict[str, Any]:
    """``inspect_compiled`` plus ``model_context``."""
    out = inspect_compiled(ff)
    out.update(model_context(ff))
    return out
