"""Search-drift calibration: predicted vs measured step time.

The port's counterpart of ``flexflow_tpu/obs/drift.py``, with the same
``.drift.json`` fields, so that the JAX package's ``scripts/calibrate.py
--ingest-drift`` reads it. ``drift_report`` rebuilds the search's
prediction of one training step from per-op costs (the measured table of
``search/profile.py`` when ``--search-measure-ops`` or ``--profiling``
ran, the analytic roofline otherwise) divided by each op's sharding work
division, plus machine-model collective costs priced from the step's
collective census, and compares it with the tracer's measured step time.
The port runs one card, whose census is empty, so the comms half is 0
(a collective on one device is free, as in the JAX package's
``collective_time``). ``collective_drift`` stamps its rows with the
platform of the model's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def work_division(node, mesh) -> int:
    """How many ways the strategy splits this op's work: the product of
    the mesh-axis extents its primary output is sharded over (the analog
    of the reference scaling measured op cost by the MachineView degree)."""
    axis_sizes = dict(mesh.shape)
    spec = node.output_specs[0] if node.output_specs else None
    if spec is None:
        return 1
    div = 1
    for entry in spec:
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            div *= axis_sizes.get(axis, 1)
    return max(div, 1)


def _analytic_op_cost(op, machine_spec) -> float:
    """Roofline forward-pass estimate when no measured table exists:
    max(FLOP time at MXU efficiency, HBM time for in+out+params),
    floored at the per-kernel dispatch overhead."""
    import numpy as np

    flop_s = op.flops() / (machine_spec.flops
                           * getattr(machine_spec, "mxu_efficiency", 0.55))
    bytes_ = 4.0 * (sum(float(np.prod(s)) for s in op.input_shapes)
                    + sum(float(np.prod(s)) for s in op.output_shapes)
                    + float(op.params_elems()))
    mem_s = bytes_ / machine_spec.hbm_bw
    return max(flop_s, mem_s, getattr(machine_spec, "min_op_time", 5e-7))


def predicted_step_time(ff, measured: Optional[Dict[str, float]] = None
                        ) -> Dict[str, Any]:
    """Per-op + comms prediction of one training-step wall time.

    ``measured``: profile.py's ``{"<guid>:fwd": s, "<guid>:bwd": s}``
    table (defaults to ``ff.op_profile`` when ``--profiling`` or
    ``--search-measure-ops`` populated it); an op is priced at the rows
    of the core that runs it (``profile.executed_rows``). Ops absent
    from the table fall back to the analytic roofline — per-op rows
    record which source priced them.
    """
    from flexflow_tpu_torch.search.profile import (executed_impl,
                                                   executed_rows)
    measured = measured if measured is not None else (ff.op_profile or {})
    mesh = ff.mesh
    spec = ff.machine_spec
    per_op: List[Dict[str, Any]] = []
    compute_s = 0.0
    for node in ff.executor.nodes:
        op = node.op
        # the core that executes: attention's "<guid>:fwd:flash" rows
        # where the flash kernel runs it, else the plain rows
        fwd, bwd = executed_rows(measured, op.guid, executed_impl(ff, op))
        source = "measured"
        if fwd is None:
            fwd = _analytic_op_cost(op, spec)
            bwd = 2.0 * fwd
            source = "analytic"
        elif bwd is None:
            bwd = 2.0 * fwd
        div = work_division(node, mesh)
        op_s = (fwd + bwd) / div
        compute_s += op_s
        per_op.append(dict(name=op.name, guid=op.guid,
                           type=op.op_type.name, fwd_s=fwd, bwd_s=bwd,
                           work_div=div, sharded_s=op_s, source=source))
    overhead_s = float(measured.get("__step_overhead__", 0.0))
    return dict(compute_s=compute_s, step_overhead_s=overhead_s,
                per_op=per_op,
                measured_ops=sum(1 for r in per_op
                                 if r["source"] == "measured"))


def predicted_comm_time(ff, census: Dict[str, Dict[str, float]]
                        ) -> Dict[str, Any]:
    """Price the step's collective census (``{kind: {count, bytes}}``)
    through the machine model: the comms half of the prediction, fed by
    what the step emits. On one device every collective is free (the
    JAX package's ``collective_time`` at one chip); the port's census on
    one card is empty. Pricing a census over several devices comes with
    multi-GPU execution and raises until then."""
    n_chips = int(ff.mesh.size)
    spec = ff.machine_spec
    corr = getattr(spec, "collective_corrections", None) or {}
    per_kind: Dict[str, Dict[str, float]] = {}
    total = 0.0
    for kind, entry in (census or {}).items():
        if n_chips > 1:
            raise NotImplementedError(
                "pricing a collective census over more than one device: "
                "multi-GPU execution is ROADMAP.md Queue 1 item 3.2")
        t = 0.0
        row = dict(entry, predicted_s=t)
        # when a measured correction is already applied to this spec,
        # also record the raw analytic time: the per-kind drift ratio
        # must be measured / UNCALIBRATED so re-ingesting a corrected
        # run derives the same absolute factor (replace converges)
        # instead of the residual ~1.0 (which would un-calibrate it)
        f = corr.get(kind)
        if f:
            row["predicted_uncorrected_s"] = t / f
        per_kind[kind] = row
        total += t
    return dict(comm_s=total, per_kind=per_kind)


def collective_drift(per_kind_predicted: Dict[str, Dict[str, Any]],
                     measured_collectives: Dict[str, Dict[str, float]],
                     platform: Optional[str] = None
                     ) -> Dict[str, Dict[str, Any]]:
    """Join measured per-collective device time (obs/devtrace.py
    attribution, ``{kind: {per_step_s, ...}}``) against the simulator-
    priced census (``predicted_comm_time``'s per-kind rows). Each kind
    gets ``measured_s`` / ``predicted_s`` / ``ratio`` — the per-kind
    correction signal ``scripts/calibrate.py --ingest-drift`` folds into
    CALIBRATION.json ``collective_corrections`` (the measured hook the
    machine model's wus_rs/ag_time terms calibrate against).

    ``ratio`` is measured / UNCORRECTED-analytic
    (``predicted_uncorrected_s`` when the pricing spec already carried a
    correction, else ``predicted_s``): the derived factor is absolute,
    so re-ingesting a run priced with corrections applied replaces the
    stored factor with the same value instead of its ~1.0 residual.

    ``platform`` (when known) stamps each row ``ingestable``: a drift
    ratio measured on the CPU compares host-CPU wall time against
    analytic interconnect pricing — 400-600x "drift" that is backend
    mismatch, not calibration signal — so CPU-platform rows are marked
    ``ingestable: false`` and ``calibrate.py --ingest-drift`` skips
    them instead of deriving corrections."""
    out: Dict[str, Dict[str, Any]] = {}
    for kind in sorted(set(per_kind_predicted) | set(measured_collectives)):
        prow = per_kind_predicted.get(kind) or {}
        pred = prow.get("predicted_s")
        base = prow.get("predicted_uncorrected_s", pred)
        meas = (measured_collectives.get(kind) or {}).get("per_step_s")
        row: Dict[str, Any] = dict(predicted_s=pred, measured_s=meas)
        if base and meas and base > 0:
            row["ratio"] = meas / base
        if platform is not None:
            row["ingestable"] = platform != "cpu"
        out[kind] = row
    return out


def drift_report(ff, measured_step_s: Optional[float],
                 census: Optional[Dict[str, Dict[str, float]]] = None,
                 measured: Optional[Dict[str, float]] = None,
                 phase_summary: Optional[Dict[str, Any]] = None,
                 measured_collectives: Optional[
                     Dict[str, Dict[str, float]]] = None,
                 step_metrics: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """The calibration report: predicted-vs-measured step-time ratio.

    ``measured_step_s``: steady-state step wall time (tracer median).
    ``census``: collective census from the compiled step (inspector);
    None prices zero comms. Also carries the native search's own
    prediction (``search_info["predicted_time"]``) when one exists, so
    drift of the REAL search — not just this reconstruction — is
    visible.

    ``measured_collectives``: per-kind measured device time from the
    device-trace attribution (``{kind: {per_step_s, ...}}``); when
    present the report gains a ``collective_drift`` section joining it
    against the census-priced prediction. ``step_metrics``: the
    goodput/MFU/step-percentile dict from
    ``obs.devtrace.record_step_metrics``, carried along for the run
    report.
    """
    pred = predicted_step_time(ff, measured=measured)
    comm = predicted_comm_time(ff, census or {})
    total = pred["compute_s"] + pred["step_overhead_s"] + comm["comm_s"]
    ratio = (total / measured_step_s
             if measured_step_s and measured_step_s > 0 else None)
    search_pred = None
    if isinstance(ff.search_info, dict):
        search_pred = ff.search_info.get("predicted_time")
    search_ratio = (search_pred / measured_step_s
                    if search_pred and measured_step_s else None)
    report = dict(
        predicted=dict(total_s=total,
                       compute_s=pred["compute_s"],
                       comm_s=comm["comm_s"],
                       step_overhead_s=pred["step_overhead_s"],
                       measured_ops=pred["measured_ops"],
                       num_ops=len(pred["per_op"])),
        measured=dict(step_s=measured_step_s),
        ratio=ratio,
        search_predicted_s=search_pred,
        search_ratio=search_ratio,
        per_op=pred["per_op"],
        comm=comm["per_kind"],
        mesh_axes=dict(ff.mesh.shape),
    )
    if phase_summary:
        report["phases"] = phase_summary
    if measured_collectives is not None:
        from flexflow_tpu_torch.obs.artifacts import device_identity
        platform = device_identity(ff.device)[0]
        report["collective_drift"] = collective_drift(
            comm["per_kind"], measured_collectives, platform=platform)
    if step_metrics:
        report["step_metrics"] = step_metrics
    return report
