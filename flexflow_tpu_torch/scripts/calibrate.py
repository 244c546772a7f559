"""Calibrate the port's search cost model against the device.

Per model: (1) time every distinct op on the device
(``search/profile.py`` ``microbenchmark``: CUDA-graph slope timing on the
card) and hand the times to the native simulator's measured channel;
(2) simulate one training iteration on one device; (3) time the real
``fit`` step (slope of two run lengths, each ending in host reads) and
read what its replayed steps hold on the card (the allocator's peak
with the CUDA-graph pool, less what the process held before the model
was built);
report predicted/actual for time and memory. The rows land in the port's
calibration file (``search/profile.py`` ``calibration_path``:
``FFS_CALIBRATION_FILE``, else the repo root's ``CALIBRATION_GPU.json``),
whose median ``mem_ratio`` the memory-capped search divides its threshold
by (``search/unity.py`` ``_memory_correction``). The JAX package's
``CALIBRATION.json`` is never read or written.

Usage:
    python -m flexflow_tpu_torch.scripts.calibrate [--quick]
        [--device cuda|cpu] [--measured-cache PATH]
    python -m flexflow_tpu_torch.scripts.calibrate --ingest-drift TRACE_DIR

On the card the sweep takes the full set at its widths (the BERT-proxy
``TransformerConfig()``, ResNet-50 at batch 64 and 224 px, AlexNet at
batch 64, the 4096-wide MLP); ``--quick`` and the CPU take small ones.
The measured-op cache is written only where ``--measured-cache`` points.

``--ingest-drift`` folds the ``*.drift.json`` reports of a traced run
(``fit(..., trace_dir=...)``) into the file as ``drift_report`` rows,
and derives per-op-type (``op_corrections``) and per-collective
(``collective_corrections``) factors, keyed by platform, which
``search/profile.py`` and ``machine.py`` apply on that platform only.
"""

from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import sys
import time

import numpy as np

TOLERANCE = 0.25  # |predicted/actual - 1| target

# Per-dispatch residual above which a model's measured step is
# launch-dominated: when the unmodelled gap (actual - predicted) spread
# over the graph's op count exceeds this, the miss is fixed per-dispatch
# host overhead, not mispriced compute, which the tolerance gate audits.
LAUNCH_RESIDUAL_PER_OP_S = 1e-4


def stamp_launch_dominated(row) -> bool:
    """Stamp ``launch_dominated`` on one results row (predicted_s /
    actual_s / ops_total or num_ops). Returns the stamped value."""
    pred = row.get("predicted_s")
    act = row.get("actual_s")
    ops = row.get("ops_total") or row.get("num_ops")
    dominated = bool(
        pred is not None and act is not None and ops
        and act > pred
        and (act - pred) / ops >= LAUNCH_RESIDUAL_PER_OP_S)
    row["launch_dominated"] = dominated
    return dominated


def build_models(quick: bool, device):
    """[(name, make, loss kind)] of the sweep on ``device``; ``make()``
    creates its (uncompiled) model when called, so that one model at a
    time holds the device."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.models.alexnet import create_alexnet
    from flexflow_tpu_torch.models.mlp import create_mlp
    from flexflow_tpu_torch.models.resnet import ResNetConfig, create_resnet
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)

    def cfg(bs):
        return FFConfig(batch_size=bs, workers_per_node=1, num_nodes=1)

    if quick:
        tcfg = TransformerConfig(num_layers=2, hidden_size=128, num_heads=4,
                                 seq_length=64, batch_size=8)
        return [
            ("bert_proxy", lambda: create_transformer(tcfg, cfg(8),
                                                      device=device), "mse"),
            ("mlp", lambda: create_mlp(batch_size=16, in_dim=64,
                                       hidden_dims=(128, 128), out_dim=10,
                                       ff_config=cfg(16), device=device),
             "cat"),
            ("alexnet", lambda: create_alexnet(batch_size=4, num_classes=10,
                                               ff_config=cfg(4),
                                               device=device), "cat"),
        ]
    tcfg = TransformerConfig()  # the BERT-proxy at its full width
    # ResNet-50 at the reference's benchmark batch: the sizes where the
    # simulator must be right
    rcfg = ResNetConfig(batch_size=64, image_size=224, stages=(3, 4, 6, 3))
    return [
        ("bert_proxy", lambda: create_transformer(
            tcfg, cfg(tcfg.batch_size), device=device), "mse"),
        ("resnet", lambda: create_resnet(rcfg, cfg(rcfg.batch_size),
                                         device=device), "cat"),
        ("alexnet", lambda: create_alexnet(batch_size=64, num_classes=10,
                                           ff_config=cfg(64), device=device),
         "cat"),
        # kept on purpose: a small batch and 4096-wide weights, whose step
        # a per-op sum cannot see whole
        ("mlp", lambda: create_mlp(batch_size=64, in_dim=1024,
                                   hidden_dims=(4096, 4096, 4096),
                                   out_dim=10, ff_config=cfg(64),
                                   device=device), "cat"),
    ]


def compile_model(ff, loss_kind):
    from flexflow_tpu_torch.ffconst import LossType, MetricsType
    from flexflow_tpu_torch.optimizers import SGDOptimizer

    if loss_kind == "mse":
        ff.compile(SGDOptimizer(lr=0.01),
                   LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [MetricsType.MEAN_SQUARED_ERROR])
    else:
        ff.compile(SGDOptimizer(lr=0.01),
                   LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   [MetricsType.ACCURACY])


def example_batch(ff, loss_kind):
    rs = np.random.RandomState(0)
    xs = [rs.uniform(0.05, 1.0, size=t.shape).astype(np.float32)
          for t in ff.input_tensors]
    out_shape = ff.executor.nodes[-1].op.output_shapes[0]
    if loss_kind == "mse":
        y = rs.uniform(0, 1, size=out_shape).astype(np.float32)
    else:
        y = rs.randint(0, out_shape[-1],
                       size=(out_shape[0], 1)).astype(np.int32)
    return xs, y


def step_request(ff, measured):
    """The native simulator's request for one replicated step on one
    device. Each op takes the "rep" choice; an op whose running core was
    timed on rows of its own (attention under the flash kernel on the
    card, "<guid>:fwd:flash") takes that core's "_k:<impl>" twin, so the
    simulator prices the core that runs and not the default lowering
    that "<guid>:fwd" prices."""
    from flexflow_tpu_torch.search.profile import executed_impl
    from flexflow_tpu_torch.search.unity import (machine_to_json,
                                                 serialize_graph)

    nodes = ff.executor.nodes
    assignment = {}
    for n in nodes:
        impl = executed_impl(ff, n.op)
        timed_apart = impl and f"{n.op.guid}:fwd:{impl}" in measured
        assignment[str(n.op.guid)] = "rep" + (f"_k:{impl}" if timed_apart
                                              else "")
    return dict(
        nodes=serialize_graph(nodes, final_guid=ff.executor.final_ref[0]),
        machine=machine_to_json(ff.machine_spec, 1),
        config=dict(training=True, overlap=True,
                    opt_state_factor=0.0),  # plain SGD: no optimizer state
        mesh=dict(data=1, model=1, seq=1, expert=1),
        assignment=assignment,
        measured=measured,
    )


def predicted_step(ff, measured):
    """One-device simulated iteration through the native simulator
    (``step_request``). Returns (iteration_time_s,
    predicted_memory_bytes)."""
    from flexflow_tpu_torch.search.native import native_simulate

    resp = native_simulate(step_request(ff, measured))
    return resp["iteration_time"], resp.get("memory", 0.0)


def _inputs(xs):
    return xs if len(xs) > 1 else xs[0]


def actual_step_memory(ff, xs, y, baseline: float = 0.0,
                       steps: int = 2) -> float:
    """What ``steps`` replayed ``fit`` steps hold on the card: the
    allocator's peak over them (``torch.cuda.max_memory_allocated`` after
    a reset) as ``obs/inspect.py`` ``step_footprint_bytes`` counts it
    (with the CUDA-graph pool that holds a replay's activations), less
    ``baseline``, what the process held before the model was built; 0.0
    on the CPU, which has no device allocator."""
    import torch

    from flexflow_tpu_torch.obs.inspect import step_footprint_bytes

    if ff.device.type != "cuda":
        return 0.0
    ff.fit(_inputs(xs), y, epochs=1, verbose=False)  # the capture
    torch.cuda.synchronize(ff.device)
    torch.cuda.reset_peak_memory_stats(ff.device)
    ff.fit(_inputs(xs), y, epochs=steps, verbose=False)
    torch.cuda.synchronize(ff.device)
    peak = float(torch.cuda.max_memory_allocated(ff.device))
    return step_footprint_bytes(ff, peak) - baseline


def actual_step_time(ff, xs, y, repeats=3):
    """Seconds a ``fit`` step, slope-timed: runs of n_small and n_big
    steps (each step ending in ``fit``'s host read of its loss); the
    difference cancels the per-call constant."""
    inputs = _inputs(xs)

    def run_n(n):
        t0 = time.perf_counter()
        ff.fit(inputs, y, epochs=n, verbose=False)
        return time.perf_counter() - t0

    run_n(2)  # warm-up: the capture and the first replays
    n_small, n_big = 2, 12
    t_small = run_n(n_small)
    while True:
        t_big = run_n(n_big)
        if t_big - t_small >= 0.3 or n_big >= 4096:
            break
        n_big *= 4
    ts = [(t_big - t_small) / (n_big - n_small)]
    for _ in range(repeats - 1):
        ts.append((run_n(n_big) - run_n(n_small)) / (n_big - n_small))
    ts.sort()
    return max(ts[len(ts) // 2], 1e-9)


def derive_op_corrections(reports) -> dict:
    """Per-op-type correction factors from drift reports: each report's
    measured/predicted step ratio is attributed to op types by their
    share of the report's predicted compute; across reports the factor
    is the share-weighted mean. Keyed platform first, then op type, so
    drift observed on one platform never scales another's tables."""
    num: dict = {}  # (platform, type) -> share-weighted ratio sum
    den: dict = {}
    for rep in reports:
        pred = rep.get("predicted") or {}
        total = pred.get("total_s")
        act = (rep.get("measured") or {}).get("step_s")
        per_op = rep.get("per_op") or []
        if not (total and act and per_op):
            continue
        ratio = float(act) / float(total)
        compute = sum(float(r.get("sharded_s") or 0.0) for r in per_op)
        if compute <= 0:
            continue
        platform = (rep.get("header") or {}).get("platform") or "unknown"
        shares: dict = {}
        for r in per_op:
            t = r.get("type")
            if t:
                shares[t] = shares.get(t, 0.0) + \
                    float(r.get("sharded_s") or 0.0) / compute
        for t, share in shares.items():
            num[(platform, t)] = num.get((platform, t), 0.0) + share * ratio
            den[(platform, t)] = den.get((platform, t), 0.0) + share
    out: dict = {}
    for (platform, t) in sorted(num):
        if den[(platform, t)] <= 0:
            continue
        out.setdefault(platform, {})[t] = dict(
            factor=round(num[(platform, t)] / den[(platform, t)], 4),
            weight=round(den[(platform, t)], 4))
    return out


def derive_collective_corrections(reports) -> dict:
    """Per-collective-kind factors from drift reports that carry a
    ``collective_drift`` section (measured per-kind device time against
    the census-priced prediction), weighted across reports by each
    kind's share of the report's predicted comm time; keyed platform
    first. Rows marked ``ingestable: false`` and reports of the CPU
    platform are skipped (host time against analytic link pricing is no
    calibration signal)."""
    num: dict = {}  # (platform, kind) -> share-weighted ratio sum
    den: dict = {}
    skipped = 0
    for rep in reports:
        cd = rep.get("collective_drift") or {}
        platform = (rep.get("header") or {}).get("platform") or "unknown"
        rows = {}
        for k, r in cd.items():
            if not (r.get("ratio") and r.get("predicted_s")):
                continue
            if r.get("ingestable") is False or platform == "cpu":
                skipped += 1
                continue
            rows[k] = r
        total_pred = sum(float(r["predicted_s"]) for r in rows.values())
        if total_pred <= 0:
            continue
        for kind, r in rows.items():
            share = float(r["predicted_s"]) / total_pred
            num[(platform, kind)] = (num.get((platform, kind), 0.0)
                                     + share * float(r["ratio"]))
            den[(platform, kind)] = den.get((platform, kind), 0.0) + share
    if skipped:
        print(f"  [warn] skipped {skipped} non-ingestable collective-drift "
              f"row(s): CPU measurements against analytic link pricing are "
              f"no calibration signal")
    out: dict = {}
    for (platform, kind) in sorted(num):
        if den[(platform, kind)] <= 0:
            continue
        out.setdefault(platform, {})[kind] = dict(
            factor=round(num[(platform, kind)] / den[(platform, kind)], 4),
            weight=round(den[(platform, kind)], 4))
    return out


def _write(path: str, cal: dict) -> None:
    from flexflow_tpu_torch.obs.artifacts import atomic_write_text
    atomic_write_text(path, json.dumps(cal, indent=1))


def ingest_drift(trace_dir: str) -> int:
    """Fold ``*.drift.json`` artifacts into the calibration file.

    Each report becomes a results row (model = the trace's run name,
    predicted/actual step seconds, ratio) tagged ``source:
    "drift_report"``, keyed by (trace_dir, artifact): re-ingesting a
    directory replaces its rows; other directories' rows accumulate.
    The per-op-type and per-collective factors derived from the reports
    merge into their platform's bucket."""
    from flexflow_tpu_torch.search.profile import (calibration_path,
                                                   read_calibration)

    cal_path = calibration_path()
    cal = read_calibration(cal_path) or dict(results=[])
    cal.setdefault("results", [])
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.drift.json")))
    if not paths:
        print(f"no *.drift.json artifacts in {trace_dir}")
        return 1
    rows = []
    reports = []
    for p in paths:
        try:
            with open(p) as f:
                rep = json.load(f)
        except (OSError, ValueError) as e:
            print(f"skip {p}: {e}")
            continue
        reports.append(rep)
        header = rep.get("header", {})
        pred = (rep.get("predicted") or {}).get("total_s")
        act = (rep.get("measured") or {}).get("step_s")
        ratio = rep.get("ratio")
        if not (pred and act):
            print(f"skip {os.path.basename(p)}: no predicted/measured pair")
            continue
        rows.append(dict(
            model=str(header.get("run_name", "unknown")),
            predicted_s=float(pred),
            actual_s=float(act),
            ratio=round(float(ratio), 4) if ratio else None,
            within_tolerance=bool(ratio is not None
                                  and abs(ratio - 1.0) <= TOLERANCE),
            num_ops=(rep.get("predicted") or {}).get("num_ops"),
            source="drift_report",
            version=header.get("flexflow_tpu_version"),
            platform=header.get("platform"),
            trace_dir=os.path.abspath(trace_dir),
            artifact=os.path.basename(p),
        ))
        stamp_launch_dominated(rows[-1])
        print(f"{rows[-1]['model']:12s} predicted {pred * 1e3:8.3f} ms   "
              f"actual {act * 1e3:8.3f} ms   ratio {rows[-1]['ratio']}")
    if not rows:
        return 1
    ingested = {(r["trace_dir"], r["artifact"]) for r in rows}
    cal["results"] = [r for r in cal["results"]
                      if not (r.get("source") == "drift_report"
                              and (r.get("trace_dir"),
                                   r.get("artifact")) in ingested)] + rows
    corrections = derive_op_corrections(reports)
    n_corr = 0
    if corrections:
        merged = cal.setdefault("op_corrections", {})
        for platform, bucket in corrections.items():
            # merge within the platform's bucket only
            merged.setdefault(platform, {}).update(bucket)
            n_corr += len(bucket)
            for t, e in bucket.items():
                print(f"  correction [{platform}] {t:24s} "
                      f"x{e['factor']:.4f} (weight {e['weight']:.3f})")
    coll = derive_collective_corrections(reports)
    n_coll = 0
    if coll:
        merged = cal.setdefault("collective_corrections", {})
        for platform, bucket in coll.items():
            merged.setdefault(platform, {}).update(bucket)
            n_coll += len(bucket)
            for kind, e in bucket.items():
                print(f"  collective [{platform}] {kind:24s} "
                      f"x{e['factor']:.4f} (weight {e['weight']:.3f})")
    _write(cal_path, cal)
    print(f"ingested {len(rows)} drift report(s) into {cal_path}"
          + (f"; {n_corr} op-type correction(s) -> "
             f"search/profile.py measured tables" if n_corr else "")
          + (f"; {n_coll} per-collective correction(s) -> "
             f"machine.MachineSpec.collective_corrections" if n_coll
             else ""))
    return 0


def calibrate(device, quick: bool, cache_file=None) -> int:
    """The sweep: a results row a model, written into the calibration
    file (its drift rows and correction buckets kept); returns 0 when
    the tolerance gate passes, 1 when it fails."""
    import torch

    from flexflow_tpu_torch.obs.artifacts import device_identity
    from flexflow_tpu_torch.search.profile import (calibration_path,
                                                   microbenchmark,
                                                   read_calibration)

    platform, kind = device_identity(device)
    results = []
    for name, make, loss_kind in build_models(quick, device):
        baseline = 0.0
        if device.type == "cuda":
            # what the process holds without this model, with nothing
            # left for the collector to free during its steps
            gc.collect()
            torch.cuda.synchronize(device)
            baseline = float(torch.cuda.memory_allocated(device))
        ff = make()
        compile_model(ff, loss_kind)
        nodes = ff.executor.nodes
        measured = microbenchmark(nodes, machine_spec=ff.machine_spec,
                                  device=ff.device,
                                  dtype=ff.executor.compute_dtype,
                                  cache_file=cache_file)
        predicted, predicted_mem = predicted_step(ff, measured)
        xs, y = example_batch(ff, loss_kind)
        actual = actual_step_time(ff, xs, y)
        ratio = predicted / actual if actual > 0 else float("inf")
        actual_mem = actual_step_memory(ff, xs, y, baseline=baseline)
        mem_ratio = (actual_mem / predicted_mem
                     if predicted_mem and actual_mem else None)
        results.append(dict(
            model=name,
            predicted_s=predicted,
            actual_s=actual,
            ratio=round(ratio, 4),
            within_tolerance=bool(abs(ratio - 1.0) <= TOLERANCE),
            predicted_mem_bytes=predicted_mem,
            actual_mem_bytes=actual_mem,
            mem_ratio=round(mem_ratio, 4) if mem_ratio else None,
            ops_total=len(nodes),
            ops_measured=sum(1 for n in nodes
                             if f"{n.op.guid}:fwd" in measured),
        ))
        dominated = stamp_launch_dominated(results[-1])
        print(f"{name:12s} predicted {predicted * 1e3:8.3f} ms   "
              f"actual {actual * 1e3:8.3f} ms   ratio {ratio:.3f}   "
              f"mem {mem_ratio if mem_ratio else 'n/a'}"
              + ("   [launch-dominated]" if dominated else ""), flush=True)
        del ff
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    cal_path = calibration_path()
    old = read_calibration(cal_path)
    out = dict(platform=platform, device=kind, tolerance=TOLERANCE,
               quick=quick,
               results=results + [r for r in old.get("results", [])
                                  if r.get("source") == "drift_report"])
    for key in ("op_corrections", "collective_corrections"):
        if old.get(key):
            out[key] = old[key]
    _write(cal_path, out)
    # the gate: launch-dominated rows are left out of it (stamped in the
    # file); the BERT-proxy must be eligible and within tolerance, and a
    # majority of at least two eligible models must pass
    eligible = [r for r in results if not r.get("launch_dominated")]
    excluded = [r["model"] for r in results if r.get("launch_dominated")]
    n_ok = sum(1 for r in eligible if r["within_tolerance"])
    bert = next((r for r in eligible if r["model"] == "bert_proxy"), None)
    need = min(3, len(eligible))
    ok = (bert is not None and bert["within_tolerance"]
          and len(eligible) >= 2 and n_ok >= need)
    if excluded:
        print(f"excluded from tolerance gate (launch-dominated): "
              f"{', '.join(excluded)}")
    print(f"wrote {len(results)} row(s) to {cal_path}")
    print(f"calibration {'PASS' if ok else 'FAIL'} "
          f"({n_ok}/{len(eligible)} eligible within {TOLERANCE:.0%}, "
          f"platform {platform}, {kind})")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.scripts.calibrate",
        description=__doc__.splitlines()[0])
    ap.add_argument("--ingest-drift", metavar="TRACE_DIR",
                    help="fold a traced run's *.drift.json reports in")
    ap.add_argument("--quick", action="store_true",
                    help="the small configurations (the CPU's default)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the sweep runs (default the card)")
    ap.add_argument("--measured-cache", default=None,
                    help="per-op measurement cache file (default none)")
    args = ap.parse_args(argv)
    if args.ingest_drift:
        return ingest_drift(args.ingest_drift)
    from flexflow_tpu_torch.machine import resolve_device

    device = resolve_device(args.device)
    quick = args.quick or device.type == "cpu"
    return calibrate(device, quick, cache_file=args.measured_cache)


if __name__ == "__main__":
    sys.exit(main())
