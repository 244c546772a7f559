"""Render a run report (JSON + markdown) from a trace dir of the port.

The port's copy of the JAX package's ``scripts/obs_report.py``, reading
the artifacts ``flexflow_tpu_torch/obs`` writes beside a traced run:
``*.counters.json`` (step-time histograms, goodput and MFU gauges),
``*.devtrace.json`` (per-step device compute, comms and exposed time),
``*.drift.json`` (predicted against measured step time, per-collective
drift), ``*.summary.json`` (census and peak memory), ``*.simtrace.json``
(the simulated schedule, with the analytic twin of a learned-cost run)
and ``*.searchtrace.json``. It rolls them up per run into one
``OBS_REPORT.json`` and an optional markdown table. Standard library
only and read-only: an empty or missing dir gives an empty report and
exit 0.

Usage: python -m flexflow_tpu_torch.scripts.obs_report TRACE_DIR
           [--out PATH] [--md PATH]
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time

SUFFIXES = ("counters", "devtrace", "drift", "summary", "simtrace",
            "searchtrace")


def _load(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def collect_runs(trace_dir):
    """Group the dir's JSON artifacts by run stem
    (``fit_r00_host00`` -> {counters: ..., devtrace: ..., ...})."""
    runs = {}
    for suffix in SUFFIXES:
        for path in sorted(glob.glob(
                os.path.join(trace_dir, f"*.{suffix}.json"))):
            stem = os.path.basename(path)[:-len(f".{suffix}.json")]
            data = _load(path)
            if data is not None:
                runs.setdefault(stem, {})[suffix] = data
    return runs


def _round(v, nd=6):
    return round(v, nd) if isinstance(v, (int, float)) else v


def per_op_attribution(simtrace, drift, limit=24):
    """Join the simulated schedule's per-op priced terms against measured
    per-op seconds — the per-op granularity of the drift table (the
    learned-cost-model corpus rows). The simtrace rows carry the priced
    half plus any profile-table measurement; the drift report's per_op
    rows fill in the measured/analytic fallback.

    The two halves are NOT directly comparable: priced terms are
    per-chip SHARDED schedule durations (and include comms), measured
    seconds are whole-op UNSHARDED profile times. The ``ratio`` column
    therefore compares sharded measured compute (``measured_s`` /
    ``work_div``) against the priced COMPUTE terms only (fwd+bwd);
    ``predicted_s`` keeps the full per-chip total (with comms) as its
    own column. Rows sorted by predicted share, capped at ``limit``
    (``truncated`` records how many were dropped)."""
    sim_ops = (simtrace or {}).get("per_op") or []
    if not sim_ops:
        return None
    drift_ops = {r.get("guid"): r for r in (drift or {}).get("per_op") or []}
    rows = []
    for r in sim_ops:
        p = r.get("priced") or {}
        predicted = sum(p.get(k) or 0.0
                        for k in ("fwd_s", "bwd_s", "comm_s", "gradsync_s"))
        predicted_compute = (p.get("fwd_s") or 0.0) + (p.get("bwd_s") or 0.0)
        d = drift_ops.get(r.get("guid")) or {}
        m = r.get("measured") or {}
        measured = None
        source = m.get("source")
        if m.get("fwd_s") is not None:
            measured = (m.get("fwd_s") or 0.0) + (m.get("bwd_s") or 0.0)
        elif d.get("source") == "measured" and d.get("fwd_s") is not None:
            measured = (d.get("fwd_s") or 0.0) + (d.get("bwd_s") or 0.0)
            source = "measured"
        row = dict(name=r.get("name"), type=r.get("type"),
                   choice=r.get("choice"),
                   predicted_s=_round(predicted, 9))
        if measured is not None:
            div = r.get("work_div") or d.get("work_div") or 1
            row["measured_s"] = _round(measured, 9)
            row["work_div"] = div
            row["source"] = source
            if predicted_compute > 0 and measured > 0 and div > 0:
                row["ratio"] = _round(
                    (measured / div) / predicted_compute, 4)
        rows.append(row)
    rows.sort(key=lambda r: -(r.get("predicted_s") or 0.0))
    out = dict(ops=len(rows), rows=rows[:limit])
    if len(rows) > limit:
        out["truncated"] = len(rows) - limit
    return out


def summarize_run(stem, arts):
    """One report row per run stem, from whichever artifacts exist."""
    drift = arts.get("drift") or {}
    devtrace = arts.get("devtrace") or {}
    counters = arts.get("counters") or {}
    summary = arts.get("summary") or {}
    simtrace = arts.get("simtrace") or {}
    searchtrace = arts.get("searchtrace") or {}
    header = (drift.get("header") or devtrace.get("header")
              or counters.get("header") or summary.get("header")
              or simtrace.get("header") or {})
    m = re.match(r"(.+)_r\d+_host\d+$", stem)
    run_name = header.get("run_name") or (m.group(1) if m else stem)
    row = dict(run=stem, run_name=run_name,
               platform=header.get("platform"),
               version=header.get("flexflow_tpu_version"))
    # step-time distribution: registry reservoir percentiles first,
    # drift's step_metrics as fallback
    obs = (counters.get("observations") or {}).get(
        f"{run_name}/step_time_s") or {}
    metrics = drift.get("step_metrics") or {}
    p50 = obs.get("p50", metrics.get("step_time_p50"))
    p99 = obs.get("p99", metrics.get("step_time_p99"))
    if p50 is not None:
        row["step_time_p50_s"] = _round(p50)
    if p99 is not None:
        row["step_time_p99_s"] = _round(p99)
    gauges = counters.get("gauges") or {}
    # compile step recorded separately (never in the percentile reservoir)
    compile_s = gauges.get(f"{run_name}/compile_time_s",
                           metrics.get("compile_time_s"))
    if compile_s is not None:
        row["compile_time_s"] = _round(compile_s)
    for key in ("goodput", "mfu"):
        v = gauges.get(f"{run_name}/{key}", metrics.get(key))
        if v is not None:
            row[key] = _round(v, 8)
    if devtrace:
        tot = devtrace.get("totals") or {}
        n = devtrace.get("steps") or 0
        dt = dict(steps=n, window=devtrace.get("window"))
        for k in ("compute_s", "comms_s", "overlapped_comms_s",
                  "exposed_comms_s", "wall_s"):
            if k in tot:
                dt[k] = _round(tot[k])
        if n and tot.get("wall_s"):
            dt["exposed_comms_frac"] = _round(
                tot.get("exposed_comms_s", 0.0) / tot["wall_s"], 4)
        dt["collectives"] = {
            k: dict(per_step_s=_round(e.get("per_step_s")),
                    count=e.get("count"),
                    # hidden-vs-exposed split per kind: where the
                    # comms-compute overlap lands
                    **({"overlapped_per_step_s":
                        _round(e.get("overlapped_per_step_s")),
                        "exposed_per_step_s":
                        _round(e.get("exposed_per_step_s"))}
                       if e.get("overlapped_per_step_s") is not None
                       else {}))
            for k, e in (devtrace.get("collectives") or {}).items()}
        row["devtrace"] = dt
    if drift:
        row["drift_ratio"] = _round(drift.get("ratio"), 4)
        cd = drift.get("collective_drift")
        if cd:
            row["collective_drift"] = {
                k: dict(predicted_s=_round(e.get("predicted_s"), 9),
                        measured_s=_round(e.get("measured_s"), 9),
                        ratio=_round(e.get("ratio"), 4),
                        **({"ingestable": e["ingestable"]}
                           if "ingestable" in e else {}))
                for k, e in cd.items()}
    if summary:
        mem = summary.get("memory") or {}
        if mem.get("peak_bytes"):
            row["hbm_peak_bytes"] = mem["peak_bytes"]
        tot = summary.get("collectives_total") or {}
        if tot:
            row["collective_bytes"] = tot.get("bytes")
    if simtrace:
        pred = simtrace.get("predicted") or {}
        sim = dict(predicted_step_s=_round(pred.get("step_s"), 9),
                   fwd_s=_round(pred.get("fwd_s"), 9),
                   bwd_s=_round(pred.get("bwd_s"), 9),
                   comm_s=_round(pred.get("comm_s"), 9),
                   gradsync_s=_round(pred.get("gradsync_s"), 9))
        if pred.get("hidden_comm_s") is not None:
            # the latency-hiding term: predicted comm hidden under
            # compute, to read against devtrace's overlapped_comms_s
            sim["hidden_comm_s"] = _round(pred.get("hidden_comm_s"), 9)
        meas_p50 = row.get("step_time_p50_s")
        if pred.get("step_s") and meas_p50:
            sim["predicted_vs_measured"] = _round(
                pred["step_s"] / meas_p50, 4)
        # simulator accuracy: which model priced each op, and, when the
        # prediction used learned costs, the analytic twin's step
        # prediction beside it
        if simtrace.get("cost_sources"):
            sim["cost_sources"] = simtrace["cost_sources"]
        pred_an = (simtrace.get("predicted_analytic") or {}).get("step_s")
        if pred_an is not None:
            sim["predicted_analytic_step_s"] = _round(pred_an, 9)
            if meas_p50:
                sim["predicted_vs_measured_analytic"] = _round(
                    pred_an / meas_p50, 4)
        row["sim"] = sim
        attr = per_op_attribution(simtrace, drift)
        if attr:
            row["per_op_attribution"] = attr
    if searchtrace:
        meshes = searchtrace.get("meshes") or []
        by_status = {}
        for m in meshes:
            s = m.get("status", "unknown")
            # illegal rows are aggregated per gate with a firing count
            by_status[s] = by_status.get(s, 0) + int(m.get("count", 1))
        row["search"] = dict(
            schema_version=searchtrace.get("schema_version"),
            winner_mesh=searchtrace.get("winner_mesh"),
            mesh_candidates=sum(by_status.values()),
            mesh_status=by_status)
    return row


def build_report(trace_dir):
    runs = collect_runs(trace_dir)
    rows = [summarize_run(stem, arts)
            for stem, arts in sorted(runs.items())]
    report = dict(trace_dir=os.path.abspath(trace_dir),
                  generated_unix=time.time(),
                  runs=rows)
    merged = os.path.join(trace_dir, "merged.trace.json")
    if os.path.exists(merged):
        report["merged_trace"] = merged
    if not rows:
        report["note"] = ("no obs artifacts found — run with --trace-dir "
                          "(and --profile-steps for device attribution)")
    return report


def _fmt(v, scale=1.0, nd=3):
    return "-" if v is None else f"{v * scale:.{nd}f}"


def to_markdown(report):
    lines = ["# Observability run report", "",
             f"Trace dir: `{report['trace_dir']}`", ""]
    if not report["runs"]:
        lines.append("_" + report.get("note", "no runs") + "_")
        return "\n".join(lines) + "\n"
    lines += ["| run | p50 step ms | p99 step ms | goodput | MFU | "
              "compute ms/step | exposed comms ms/step | drift ratio |",
              "|---|---|---|---|---|---|---|---|"]
    for r in report["runs"]:
        dt = r.get("devtrace") or {}
        n = dt.get("steps") or 0
        lines.append(
            "| {run} | {p50} | {p99} | {gp} | {mfu} | {comp} | {exp} | "
            "{ratio} |".format(
                run=r["run"],
                p50=_fmt(r.get("step_time_p50_s"), 1e3),
                p99=_fmt(r.get("step_time_p99_s"), 1e3),
                gp=_fmt(r.get("goodput")),
                mfu=_fmt(r.get("mfu"), nd=6),
                comp=_fmt(dt.get("compute_s", 0.0) / n * 1e3
                          if n else None),
                exp=_fmt(dt.get("exposed_comms_s", 0.0) / n * 1e3
                         if n else None),
                ratio=_fmt(r.get("drift_ratio"))))
    # per-kind hidden-vs-exposed device time: which collective kinds the
    # overlap hides, per run
    kinds = [(r["run"], k, e) for r in report["runs"]
             for k, e in ((r.get("devtrace") or {}).get("collectives")
                          or {}).items()
             if e.get("overlapped_per_step_s") is not None]
    if kinds:
        lines += ["", "## Device collectives: hidden vs exposed", "",
                  "| run | kind | ms/step | hidden ms/step | "
                  "exposed ms/step |",
                  "|---|---|---|---|---|"]
        for run, kind, e in kinds:
            lines.append(f"| {run} | {kind} | "
                         f"{_fmt(e.get('per_step_s'), 1e3)} | "
                         f"{_fmt(e.get('overlapped_per_step_s'), 1e3)} | "
                         f"{_fmt(e.get('exposed_per_step_s'), 1e3)} |")
    drifts = [(r["run"], k, e) for r in report["runs"]
              for k, e in (r.get("collective_drift") or {}).items()]
    if drifts:
        lines += ["", "## Measured vs priced collectives", "",
                  "| run | kind | predicted s | measured s | ratio | "
                  "ingestable |",
                  "|---|---|---|---|---|---|"]
        for run, kind, e in drifts:
            ing = e.get("ingestable")
            lines.append(f"| {run} | {kind} | "
                         f"{_fmt(e.get('predicted_s'), nd=9)} | "
                         f"{_fmt(e.get('measured_s'), nd=9)} | "
                         f"{_fmt(e.get('ratio'))} | "
                         f"{'-' if ing is None else ing} |")
    sims = [r for r in report["runs"] if r.get("sim")]
    if sims:
        lines += ["", "## Simulator accuracy (predicted vs measured "
                  "step)", "",
                  "(active = whichever cost model priced the run — "
                  "`sources` counts ops per pricing source; the "
                  "analytic column appears when a learned table was "
                  "active, so the two models read side by side)", "",
                  "| run | predicted ms | analytic ms | measured p50 ms "
                  "| pred/meas | analytic/meas | sources |",
                  "|---|---|---|---|---|---|---|"]
        for r in sims:
            s = r["sim"]
            srcs = s.get("cost_sources") or {}
            src_str = " ".join(f"{k}:{v}" for k, v in sorted(srcs.items())
                               ) or "-"
            lines.append(
                f"| {r['run']} | {_fmt(s.get('predicted_step_s'), 1e3)} | "
                f"{_fmt(s.get('predicted_analytic_step_s'), 1e3)} | "
                f"{_fmt(r.get('step_time_p50_s'), 1e3)} | "
                f"{_fmt(s.get('predicted_vs_measured'))} | "
                f"{_fmt(s.get('predicted_vs_measured_analytic'))} | "
                f"{src_str} |")
    attrs = [(r["run"], row) for r in report["runs"]
             for row in (r.get("per_op_attribution") or {}).get("rows", [])]
    if attrs:
        lines += ["", "## Per-op predicted vs measured", "",
                  "(measured = whole-op profile seconds; compute ratio "
                  "= (measured / work_div) / priced fwd+bwd)", "",
                  "| run | op | type | choice | predicted ms | "
                  "measured ms | div | compute ratio |",
                  "|---|---|---|---|---|---|---|---|"]
        for run, row in attrs:
            lines.append(
                f"| {run} | {row.get('name')} | {row.get('type')} | "
                f"{row.get('choice') or '-'} | "
                f"{_fmt(row.get('predicted_s'), 1e3)} | "
                f"{_fmt(row.get('measured_s'), 1e3)} | "
                f"{row.get('work_div', '-')} | "
                f"{_fmt(row.get('ratio'))} |")
    return "\n".join(lines) + "\n"


def main(argv):
    opts = {}
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("--out", "--md"):
            i += 1
            if i >= len(argv):
                print(f"obs_report.py: {a} expects a path", file=sys.stderr)
                return 2
            opts[a] = argv[i]
        else:
            args.append(a)
        i += 1
    if len(args) != 1:
        print("usage: python -m flexflow_tpu_torch.scripts.obs_report "
              "TRACE_DIR [--out PATH] [--md PATH]", file=sys.stderr)
        return 2

    trace_dir = args[0]
    out = opts.get("--out") or os.path.join(trace_dir, "OBS_REPORT.json")
    report = build_report(trace_dir)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    md = opts.get("--md")
    if md:
        with open(md, "w") as f:
            f.write(to_markdown(report))
    print(f"obs report: {len(report['runs'])} run(s) -> {out}"
          + (f" + {md}" if md else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
