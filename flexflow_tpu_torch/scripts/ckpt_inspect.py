"""Inspect a v2 per-shard checkpoint directory of the port.

Renders the step inventory and the newest complete checkpoint's
manifest as a human-readable summary (or ``--json``), re-verifies
shard checksums and coverage (``--no-deep`` skips the byte-level
re-read), and exits nonzero when the directory holds no complete,
intact checkpoint — the shape a preemption handler or CI gate wants:

    python -m flexflow_tpu_torch.scripts.ckpt_inspect /ckpts/run42
    python -m flexflow_tpu_torch.scripts.ckpt_inspect \
        /ckpts/run42/step_00000040 --json

Exit codes: 0 newest checkpoint complete and verified; 1 newest
checkpoint exists but fails verification; 2 no complete checkpoint at
all. The port's counterpart of the JAX package's
``scripts/ckpt_inspect.py``, over ``flexflow_tpu_torch/ckpt/manifest.py``
``verify_step_dir``; it reads files only (no device).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GB"


def inspect(path: str, deep: bool = True) -> dict:
    from flexflow_tpu_torch.ckpt import manifest as mf

    out: dict = {"path": path, "steps": [], "latest": None}
    if os.path.isfile(os.path.join(path, mf.MANIFEST_NAME)):
        steps = [(None, path, True)]
    else:
        steps = mf.list_steps(path)
    for step, sdir, ok in steps:
        out["steps"].append(dict(step=step, dir=os.path.basename(sdir),
                                 committed=ok))
    complete = [(s, p) for s, p, ok in steps if ok]
    if not complete:
        return out
    step, sdir = complete[-1]
    rep = mf.verify_step_dir(sdir, deep=deep)
    manifest = rep.pop("manifest") or {}
    strategy = manifest.get("strategy") or {}
    choices = {}
    for op in (strategy.get("ops") or {}).values():
        c = op.get("choice") or "<none>"
        choices[c] = choices.get(c, 0) + 1
    out["latest"] = dict(
        step=manifest.get("step"),
        iteration=manifest.get("iteration"),
        mesh=manifest.get("mesh"),
        num_devices=manifest.get("num_devices"),
        num_hosts=rep["num_hosts"],
        leaves=len(manifest.get("leaves", {})),
        shard_count=rep["shard_count"],
        payload_bytes=rep["payload_bytes"],
        rng_saved=bool(manifest.get("rng")),
        strategy_choices=choices,
        verified=rep["complete"],
        deep=deep,
        errors=rep["errors"],
    )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.scripts.ckpt_inspect",
        description=__doc__.split("\n")[0])
    ap.add_argument("path", help="checkpoint root or a step_* directory")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--no-deep", action="store_true",
                    help="skip the byte-level checksum re-read")
    args = ap.parse_args(argv)
    report = inspect(args.path, deep=not args.no_deep)
    latest = report["latest"]
    if args.json:
        print(json.dumps(report, indent=1))
    else:
        if not report["steps"]:
            print(f"{args.path}: no checkpoint step directories")
        for row in report["steps"]:
            mark = "committed" if row["committed"] else "PARTIAL (no manifest)"
            print(f"  {row['dir']:<16s} {mark}")
        if latest:
            print(f"newest complete checkpoint: step {latest['step']} "
                  f"(iteration {latest['iteration']})")
            print(f"  mesh {latest['mesh']} over {latest['num_devices']} "
                  f"device(s), {latest['num_hosts']} host file(s)")
            print(f"  {latest['leaves']} leaves in {latest['shard_count']} "
                  f"shards, {_fmt_bytes(latest['payload_bytes'])} payload, "
                  f"rng {'saved' if latest['rng_saved'] else 'MISSING'}")
            ch = ", ".join(f"{k} x{v}" for k, v in
                           sorted(latest["strategy_choices"].items()))
            print(f"  strategy choices: {ch or '<none recorded>'}")
            verdict = ("verified" if latest["verified"] else
                       f"FAILED verification ({len(latest['errors'])} "
                       f"error(s))")
            print(f"  integrity: {verdict}"
                  + ("" if not args.no_deep else " (structure only)"))
            for e in latest["errors"]:
                print(f"    ERROR {e}")
    if latest is None:
        if not args.json:
            print("no complete checkpoint — nothing restorable here")
        return 2
    return 0 if latest["verified"] else 1


if __name__ == "__main__":
    sys.exit(main())
