"""Per-op roofline attribution for a compiled model.

The port's counterpart of ``flexflow_tpu/obs/roofline.py``, with the
same rows and aggregates. Each op is timed standalone on the model's
device (``search/profile.measure_op``: CUDA-graph slope timing on the
card), its analytic FLOPs and bytes (at the compute dtype's width) give
an arithmetic intensity, and the machine's peaks (``machine_spec.flops``
and ``hbm_bw``: on ``"h100-sxm"`` the bf16 dense peak and HBM3's rate)
name the op compute- or bandwidth-bound. ``bound_share`` is the larger
of the op's achieved shares of the two (its roofline bound over its
measured time); a share above 1 is a fault in the count or the timing,
and the row says so in ``over_bound`` (the markdown marks it). Shares
are never clipped.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from flexflow_tpu_torch.ffconst import OperatorType

# op-class buckets for the per-class efficiency aggregates
CONV_FAMILY = {OperatorType.CONV2D, OperatorType.POOL2D,
               OperatorType.BATCHNORM, OperatorType.GROUPNORM}
MATMUL_FAMILY = {OperatorType.LINEAR, OperatorType.BATCHMATMUL,
                 OperatorType.MULTIHEAD_ATTENTION, OperatorType.EXPERTS,
                 OperatorType.EINSUM}


def _op_class(op) -> str:
    if op.op_type in CONV_FAMILY:
        return "conv"
    if op.op_type in MATMUL_FAMILY:
        return "matmul"
    return "other"


def roofline_report(nodes, machine_spec, repeats: int = 3, warmup: int = 1,
                    dtype_size: Optional[float] = None,
                    include_bwd: bool = True, device=None,
                    dtype=None) -> Dict[str, Any]:
    """Time every op in an OpNode list and attribute it on the roofline.

    Returns ``{"rows": [...], "classes": {...}, "machine": {...},
    "meta": {"dtype_size": width}}``.
    Each row: op name/type/class, shapes, flops, bytes, intensity
    (flop/byte), measured fwd/bwd seconds, achieved FLOP/s and bytes/s,
    MFU (fraction of chip peak), and ``bound`` — which roofline wall the
    op sits under at the machine's ridge point. Ops whose standalone
    forward cannot run are reported with ``error`` instead of numbers.
    ``device`` and ``dtype`` are where and in what the ops are timed
    (the model's device and compute dtype; the card when ``device`` is
    None, the CPU only by name, and f32 when ``dtype`` is None); the
    device must be the one ``machine_spec`` describes. The bytes are
    counted at ``dtype``'s width; ``dtype_size``, the reference's
    parameter, gives the width only where no ``dtype`` is given.
    """
    import torch

    from flexflow_tpu_torch.machine import check_spec_device, resolve_device
    from flexflow_tpu_torch.search.profile import (OpNotMeasurable,
                                                   measure_op, node_layout,
                                                   op_io_bytes)

    device = resolve_device(device)
    check_spec_device(machine_spec, device)
    if dtype is not None:
        width = float(torch.empty((), dtype=dtype).element_size())
        if dtype_size is not None and float(dtype_size) != width:
            raise ValueError(f"dtype_size {dtype_size} is not the width of "
                             f"{dtype} ({width:g} bytes)")
        dtype_size = width
    elif dtype_size is None:
        dtype_size = 4.0  # measure_op's default dtype, f32

    peak_flops = float(machine_spec.flops)
    hbm_bw = float(machine_spec.hbm_bw)
    ridge = peak_flops / hbm_bw  # flop/byte where the two walls meet
    rows: List[Dict[str, Any]] = []
    for node in nodes:
        op = node.op
        row: Dict[str, Any] = dict(
            name=op.name,
            type=op.op_type.name,
            op_class=_op_class(op),
            layout=node_layout(node),
            input_shapes=[list(s) for s in op.input_shapes],
            output_shapes=[list(s) for s in op.output_shapes],
        )
        flops = float(op.flops())
        bytes_ = op_io_bytes(op, dtype_size)
        row["flops"] = flops
        row["bytes"] = bytes_
        row["intensity"] = flops / bytes_ if bytes_ else None
        # which wall the op sits under *analytically*, independent of how
        # well the kernel runs: under the ridge point it cannot beat HBM
        row["bound"] = ("compute" if bytes_ and flops / bytes_ >= ridge
                        else "bandwidth")
        try:
            fwd_s, bwd_s = measure_op(op, hbm_bw, device=device, dtype=dtype,
                                      layout=row["layout"], repeats=repeats,
                                      warmup=warmup, include_bwd=include_bwd)
        except OpNotMeasurable as e:  # standalone-unrunnable op: keep row
            row["error"] = f"{type(e).__name__}: {e}"
            rows.append(row)
            continue
        row["fwd_s"] = fwd_s
        if include_bwd:
            row["bwd_s"] = bwd_s
        row["achieved_flops"] = flops / fwd_s if fwd_s else None
        row["achieved_bw"] = bytes_ / fwd_s if fwd_s else None
        row["mfu"] = flops / fwd_s / peak_flops if fwd_s else None
        row["hbm_frac"] = bytes_ / fwd_s / hbm_bw if fwd_s else None
        row["bound_share"] = (max(row["mfu"], row["hbm_frac"])
                              if fwd_s else None)
        row["over_bound"] = bool(fwd_s) and row["bound_share"] > 1.0
        rows.append(row)
    return dict(rows=rows, classes=class_aggregates(rows),
                machine=dict(chip=machine_spec.chip, peak_flops=peak_flops,
                             hbm_bw=hbm_bw, ridge_intensity=ridge),
                # the element width the bytes column counts at: a reader
                # splitting bytes into activations and parameters needs it
                meta=dict(dtype_size=dtype_size))


def class_aggregates(rows) -> Dict[str, Dict[str, float]]:
    """Per-op-class totals: the conv-vs-matmul efficiency evidence. The
    ``efficiency`` figure (class FLOPs / class measured time / peak) is
    the number to feed ``MachineSpec.conv_efficiency``."""
    agg: Dict[str, Dict[str, float]] = {}
    for r in rows:
        if "fwd_s" not in r:
            continue
        a = agg.setdefault(r["op_class"],
                           dict(ops=0, flops=0.0, bytes=0.0, fwd_s=0.0))
        a["ops"] += 1
        a["flops"] += r["flops"]
        a["bytes"] += r["bytes"]
        a["fwd_s"] += r["fwd_s"]
    return agg


def finish_aggregates(agg, peak_flops: float) -> None:
    """Attach achieved-FLOP/s and efficiency to class aggregates in
    place (separate from collection so callers can merge reports)."""
    for a in agg.values():
        t = a.get("fwd_s") or 0.0
        a["achieved_flops"] = a["flops"] / t if t else None
        a["efficiency"] = a["flops"] / t / peak_flops if t else None


def format_markdown(report, top: Optional[int] = 20) -> str:
    """Markdown roofline table, heaviest ops first (by measured fwd
    time), plus the per-class aggregate block."""
    rows = [r for r in report["rows"] if "fwd_s" in r]
    rows.sort(key=lambda r: -r["fwd_s"])
    skipped = len(report["rows"]) - len(rows)
    lines = [
        "| op | class | layout | fwd us | GFLOP/s | GB/s | MFU | bound |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows[:top]:
        lines.append(
            f"| {r['name']} | {r['op_class']} | {r['layout']} "
            f"| {r['fwd_s'] * 1e6:.1f} "
            f"| {(r['achieved_flops'] or 0) / 1e9:.1f} "
            f"| {(r['achieved_bw'] or 0) / 1e9:.1f} "
            f"| {(r['mfu'] or 0) * 100:.2f}% | {r['bound']}"
            + (" OVER BOUND" if r.get("over_bound") else "") + " |")
    if top and len(rows) > top:
        lines.append(f"| ... ({len(rows) - top} more ops) | | | | | | | |")
    if skipped:
        lines.append(f"\n({skipped} ops unmeasurable standalone — see the "
                     f"JSON rows' `error` fields)")
    agg = dict(report["classes"])
    finish_aggregates(agg, report["machine"]["peak_flops"])
    lines.append("\nPer-class aggregates (feed `efficiency` of the conv "
                 "class to `MachineSpec.conv_efficiency`):\n")
    lines.append("| class | ops | total fwd ms | GFLOP/s | efficiency |")
    lines.append("|---|---|---|---|---|")
    for name, a in sorted(agg.items()):
        lines.append(
            f"| {name} | {a['ops']} | {a['fwd_s'] * 1e3:.2f} "
            f"| {(a['achieved_flops'] or 0) / 1e9:.1f} "
            f"| {(a['efficiency'] or 0) * 100:.2f}% |")
    bw_bound = sum(1 for r in rows if r["bound"] == "bandwidth")
    lines.append(f"\n{bw_bound}/{len(rows)} measured ops are "
                 f"bandwidth-bound at the machine ridge point "
                 f"({report['machine']['ridge_intensity']:.1f} flop/byte).")
    return "\n".join(lines)
