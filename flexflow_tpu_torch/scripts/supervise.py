"""Restart a training command of the port on preemption, hang or crash.

Runs the training command as a subprocess, classifies its exit code
(clean / kill / preempted / hung / crash: the codes
``flexflow_tpu_torch/runtime_health.py`` and the ``FFS_FAULT`` harness
give), and restarts it with ``--resume`` under a bounded exponential
backoff. With ``grace_window_s`` / ``watchdog_timeout_s`` on the
training side, a preempted or hung job checkpoints itself, exits with a
classifiable code, and comes back without a human. The port's
counterpart of the JAX package's ``scripts/supervise.py``, over
``runtime_health.Supervisor``.

Usage:

    python -m flexflow_tpu_torch.scripts.supervise [--max-restarts N]
        [--backoff-base S] [--backoff-max S] [--state PATH]
        [--keep-faults] -- python train.py --checkpoint-dir CKPTS ...

Exit code: the child's final exit code (0 after a successful run or
recovery). Restart state (counts by outcome, cumulative backoff
downtime) lands atomically in SUPERVISOR.json, by default next to the
checkpoints when the command carries ``--checkpoint-dir``, so that the
resumed run's ``goodput_effective`` counts the supervisor's downtime.

``FFS_FAULT`` (if set) reaches only the first attempt: an injected fault
models a one-time event; ``--keep-faults`` keeps it across restarts.
"""

import argparse
import os
import sys


def _infer_state_path(cmd):
    """SUPERVISOR.json next to the training command's checkpoint dir,
    when it names one — the spot CheckpointManager.finalize reads."""
    for i, a in enumerate(cmd):
        if a == "--checkpoint-dir" and i + 1 < len(cmd):
            from flexflow_tpu_torch.ckpt import manifest as mf
            return os.path.join(cmd[i + 1], mf.SUPERVISOR_NAME)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.scripts.supervise",
        description="Run a training command under self-healing "
                    "auto-resume supervision.")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="restart budget (default 3)")
    ap.add_argument("--backoff-base", type=float, default=2.0,
                    help="first restart delay in seconds; doubles per "
                         "restart (default 2)")
    ap.add_argument("--backoff-max", type=float, default=60.0,
                    help="backoff ceiling in seconds (default 60)")
    ap.add_argument("--state", default=None,
                    help="SUPERVISOR.json path (default: next to the "
                         "command's --checkpoint-dir, when present)")
    ap.add_argument("--keep-faults", action="store_true",
                    help="keep FFS_FAULT set across restarts (harness "
                         "debugging; default clears it after attempt 0)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="the training command (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no training command (usage: python -m "
                 "flexflow_tpu_torch.scripts.supervise [options] -- "
                 "python train.py ...)")

    from flexflow_tpu_torch.runtime_health import Supervisor
    state = args.state or _infer_state_path(cmd)
    sup = Supervisor(cmd, max_restarts=args.max_restarts,
                     backoff_base_s=args.backoff_base,
                     backoff_max_s=args.backoff_max,
                     state_path=state, keep_faults=args.keep_faults)
    summary = sup.run()
    outcomes = ", ".join(f"{h['outcome']}({h['code']})"
                         for h in summary["history"])
    print(f"supervise: {summary['attempts']} attempt(s) [{outcomes}], "
          f"{summary['downtime_s']:.1f}s backoff downtime, final "
          f"{summary['final_outcome']}"
          + (f" (state: {state})" if state else ""))
    code = summary["final_code"]
    if code is None or not (0 <= int(code) <= 255):
        return 1  # a signal-encoded or unreportable child exit
    return int(code)


if __name__ == "__main__":
    sys.exit(main())
