"""Train and report the port's learned cost model (``costmodel/``).

``train`` ingests the ``*.simtrace.json`` corpus (plus roofline and drift
artifacts) of one or many trace dirs, deduplicates it into
``COSTMODEL_CORPUS_GPU.json``, fits the per-op-class log-space ridge
regressions and writes ``COSTMODEL_GPU.json``, which the search finds on
the next compile (``FFS_COSTMODEL_FILE`` overrides the path,
``FFS_NO_LEARNED_COSTS=1`` turns it off). A corpus row of a newer schema
than the port's simtrace writer exits 3.

``report`` puts the simulator's accuracy beside the measurements:
per-class coverage and held-out error from the model file; per class,
the learned and the analytic roofline's error on the corpus's rows; and,
given a trace dir of traced runs, each run's predicted step (learned,
and its analytic twin) against its measured p50.

Usage:
    python -m flexflow_tpu_torch.scripts.costmodel train --trace-dir DIR
        [--trace-dir DIR2] [--corpus PATH] [--out PATH] [--min-rows 8]
    python -m flexflow_tpu_torch.scripts.costmodel report [--model PATH]
        [--corpus PATH] [--trace-dir DIR] [--json]

The defaults are the repo root's ``COSTMODEL_CORPUS_GPU.json`` and
``COSTMODEL_GPU.json``. It reads and writes files only: no device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any, Dict, List, Optional

from flexflow_tpu_torch.costmodel import (CorpusSchemaError, CostModel,
                                          build_corpus, load_corpus,
                                          save_corpus, train_model)
from flexflow_tpu_torch.costmodel.model import (MIN_CLASS_ROWS,
                                                default_model_path,
                                                repo_root)

DEFAULT_CORPUS_FILE = "COSTMODEL_CORPUS_GPU.json"


def analytic_predict(row: Dict[str, Any],
                     spec: Optional[Dict[str, float]] = None) -> float:
    """The flat analytic roofline's per-device forward seconds of a
    corpus row, the control arm of the learned-against-analytic
    comparison (``ffs_machine.hpp`` compute_time at the class asymptote,
    without the per-dim tile term the row cannot give)."""
    spec = spec or {}
    peak = float(spec.get("flops", 1e12))
    hbm = float(spec.get("hbm_bw", 100e9))
    eff = float(spec.get("conv_efficiency", 0.35)
                if row.get("type") == "CONV2D"
                else spec.get("mxu_efficiency", 0.55))
    min_op = float(spec.get("min_op_time", 5e-7))
    div = max(1.0, float(row.get("work_div") or 1.0))
    flop_s = float(row.get("flops") or 0.0) / div / max(peak * eff, 1.0)
    mem_s = float(row.get("io_bytes") or 0.0) / div / max(hbm, 1.0)
    return max(flop_s, mem_s) + min_op


def _spec_for_platform(platform: str) -> Dict[str, float]:
    """The machine figures of a model's platform: the CPU simulation's
    for "cpu" (and "unknown"), the H100's table entry for "gpu"."""
    from flexflow_tpu_torch.machine import CHIP_SPECS
    chip = "cpu-sim" if platform in ("cpu", "unknown") else "h100-sxm"
    s = dict(CHIP_SPECS[chip])
    s.setdefault("mxu_efficiency", 0.55)
    s.setdefault("conv_efficiency", 0.35)
    s.setdefault("min_op_time", 5e-7)
    return s


def _geo_err(ratios: List[float]) -> Optional[float]:
    """exp(median |log r|): the multiplicative accuracy factor."""
    rs = [r for r in ratios if r and r > 0]
    if not rs:
        return None
    logs = sorted(abs(math.log(r)) for r in rs)
    return math.exp(logs[len(logs) // 2])


def cmd_train(args) -> int:
    dirs = args.trace_dir or []
    if not dirs:
        print("costmodel train: at least one --trace-dir is required",
              file=sys.stderr)
        return 2
    try:
        corpus = build_corpus(dirs)
    except CorpusSchemaError as e:
        print(f"costmodel: CORPUS SCHEMA DRIFT: {e}", file=sys.stderr)
        return 3
    rows = corpus.get("rows") or []
    if not rows:
        print(f"costmodel: no trainable corpus rows in {dirs} (need "
              f"simtrace rows with measured seconds: a traced fit of a "
              f"model compiled with --profiling, or a roofline report)",
              file=sys.stderr)
        return 1
    corpus_path = args.corpus or os.path.join(repo_root(),
                                              DEFAULT_CORPUS_FILE)
    save_corpus(corpus_path, corpus)
    model = train_model(corpus, min_rows=args.min_rows)
    if not model.classes:
        print(f"costmodel: {len(rows)} rows but no op class reached the "
              f"coverage gate ({args.min_rows} rows): collect more traces "
              f"before training", file=sys.stderr)
        return 1
    out_path = args.out or os.path.join(repo_root(), "COSTMODEL_GPU.json")
    model.save(out_path)
    print(f"corpus: {len(rows)} rows from {len(dirs)} dir(s) "
          f"-> {corpus_path}")
    for k, n in sorted(corpus.get("classes", {}).items()):
        trained = model.classes.get(k)
        if trained is not None:
            print(f"  {k:28s} {n:4d} rows  ->  trained "
                  f"(train {trained.n_train} / test {trained.n_test}, "
                  f"held-out err x{trained.err_factor:.3f})")
        else:
            print(f"  {k:28s} {n:4d} rows  ->  below coverage gate "
                  f"({args.min_rows}): analytic fallback")
    if model.corpus_rows < len(rows):
        print(f"  [note] trained on the {model.platform} rows only "
              f"({model.corpus_rows}/{len(rows)}): rows of two platforms "
              f"never blend into one regression")
    print(f"model: {len(model.classes)} class(es), platform "
          f"{model.platform} -> {out_path}")
    return 0


def _trace_dir_accuracy(trace_dir: str) -> List[Dict[str, Any]]:
    """Per-run predicted-against-measured step rows of a trace dir: the
    ``obs_report`` join, in this report's vocabulary."""
    from flexflow_tpu_torch.scripts import obs_report as obs
    out: List[Dict[str, Any]] = []
    for stem, arts in sorted(obs.collect_runs(trace_dir).items()):
        if "simtrace" not in arts:
            continue
        r = obs.summarize_run(stem, arts)
        sim = r.get("sim") or {}
        row = dict(run=stem,
                   predicted_s=sim.get("predicted_step_s"),
                   measured_s=r.get("step_time_p50_s"),
                   cost_sources=sim.get("cost_sources"))
        if sim.get("predicted_analytic_step_s") is not None:
            row["predicted_analytic_s"] = sim["predicted_analytic_step_s"]
        if sim.get("predicted_vs_measured") is not None:
            row["sim_accuracy_ratio"] = sim["predicted_vs_measured"]
        if sim.get("predicted_vs_measured_analytic") is not None:
            row["sim_accuracy_ratio_analytic"] = \
                sim["predicted_vs_measured_analytic"]
        out.append(row)
    return out


def cmd_report(args) -> int:
    model_path = args.model or default_model_path()
    try:
        model = CostModel.load(model_path)
    except (OSError, ValueError) as e:
        print(f"costmodel report: no trained model at {model_path} ({e}): "
              f"run `python -m flexflow_tpu_torch.scripts.costmodel train` "
              f"first", file=sys.stderr)
        return 2
    report: Dict[str, Any] = dict(
        model=os.path.abspath(model_path),
        platform=model.platform,
        classes={k: dict(n_train=cm.n_train, n_test=cm.n_test,
                         err_fwd=round(cm.err_fwd, 4),
                         err_factor=round(cm.err_factor, 4))
                 for k, cm in sorted(model.classes.items())})

    corpus_path = args.corpus or os.path.join(repo_root(),
                                              DEFAULT_CORPUS_FILE)
    if os.path.exists(corpus_path):
        try:
            corpus = load_corpus(corpus_path)
        except CorpusSchemaError as e:
            print(f"costmodel: CORPUS SCHEMA DRIFT: {e}", file=sys.stderr)
            return 3
        spec = _spec_for_platform(model.platform)
        per_class: Dict[str, Dict[str, List[float]]] = {}
        for r in corpus.get("rows") or []:
            m = (r.get("measured") or {})
            if not m.get("fwd_s"):
                continue
            true_s = float(m["fwd_s"]) / max(1.0, float(r.get("work_div")
                                                        or 1.0))
            pred, conf = model.predict(r)
            an = analytic_predict(r, spec)
            d = per_class.setdefault(r["type"],
                                     dict(learned=[], analytic=[],
                                          analytic_matched=[]))
            if pred is not None and conf > 0.05:
                # both arms on the same rows: the learned arm covers only
                # confident, in-hull queries, so the analytic arm is
                # also scored on that subset, beside its all-rows score
                d["learned"].append(pred / true_s)
                d["analytic_matched"].append(an / true_s)
            d["analytic"].append(an / true_s)
        acc = {}
        for k, d in sorted(per_class.items()):
            acc[k] = dict(
                rows=len(d["analytic"]),
                learned_rows=len(d["learned"]),
                learned_err_factor=_geo_err(d["learned"]),
                analytic_err_factor_matched=_geo_err(
                    d["analytic_matched"]),
                analytic_err_factor=_geo_err(d["analytic"]))
        report["corpus_accuracy"] = acc

    if args.trace_dir:
        report["step_accuracy"] = _trace_dir_accuracy(args.trace_dir)

    if args.json:
        print(json.dumps(report, indent=1))
        return 0
    print(f"# Learned cost model: {report['model']} "
          f"(platform {model.platform})")
    print("\n## Per-class coverage and held-out error")
    print("| class | train rows | test rows | held-out err factor |")
    print("|---|---|---|---|")
    for k, e in report["classes"].items():
        print(f"| {k} | {e['n_train']} | {e['n_test']} "
              f"| x{e['err_factor']:.3f} |")
    if "corpus_accuracy" in report:
        print("\n## Simulator accuracy on the corpus "
              "(per-op, pred/measured err factor: closer to 1.0 is "
              "better)")
        print("(learned and 'analytic (same rows)' score the same "
              "in-hull rows; 'analytic (all)' includes the rows the "
              "learned model declines)")
        print("| class | rows | learned (n) | analytic (same rows) | "
              "analytic (all) |")
        print("|---|---|---|---|---|")
        for k, e in report["corpus_accuracy"].items():
            le = e["learned_err_factor"]
            am = e["analytic_err_factor_matched"]
            ae = e["analytic_err_factor"]
            print(f"| {k} | {e['rows']} "
                  f"| {'x%.3f' % le if le else '-'}"
                  f" ({e['learned_rows']}) "
                  f"| {'x%.3f' % am if am else '-'} "
                  f"| {'x%.3f' % ae if ae else '-'} |")
    for row in report.get("step_accuracy") or []:
        print(f"\nstep accuracy {row['run']}: "
              f"predicted {row.get('predicted_s')} "
              f"analytic {row.get('predicted_analytic_s', '-')} "
              f"measured {row.get('measured_s')} "
              f"ratio {row.get('sim_accuracy_ratio', '-')}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.scripts.costmodel",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train", help="build the corpus and train the "
                                      "model")
    tr.add_argument("--trace-dir", action="append",
                    help="trace dir(s) holding *.simtrace.json / "
                         "*.drift.json / roofline*.json (repeatable)")
    tr.add_argument("--corpus", help="corpus output path (default "
                                     "COSTMODEL_CORPUS_GPU.json)")
    tr.add_argument("--out", help="model output path (default "
                                  "COSTMODEL_GPU.json)")
    tr.add_argument("--min-rows", type=int, default=MIN_CLASS_ROWS,
                    help="per-class coverage gate")
    rp = sub.add_parser("report", help="simulator-accuracy report")
    rp.add_argument("--model", help="model path (default: "
                                    "FFS_COSTMODEL_FILE or "
                                    "COSTMODEL_GPU.json)")
    rp.add_argument("--corpus", help="corpus path")
    rp.add_argument("--trace-dir", help="trace dir for the per-run "
                                        "step-accuracy block")
    rp.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    return cmd_train(args) if args.cmd == "train" else cmd_report(args)


if __name__ == "__main__":
    sys.exit(main())
