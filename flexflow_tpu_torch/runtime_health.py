"""Preemption-aware supervision: grace-window checkpoints, hung-collective
watchdog, self-healing auto-resume.

PyTorch counterpart of ``flexflow_tpu/runtime_health.py``, with its exit
codes, classes and injectable clock. The signal handler only sets a flag
(and arms the grace deadline): nothing in it touches CUDA, the registry
or a Python stream, so a SIGTERM that lands while the main thread is
enqueueing a CUDA-graph replay costs nothing until the step loop polls.

The reference FlexFlow runs on Legion, which owns task-level failure
handling; a reproduction on PyTorch has to build the equivalent
supervision layer itself. On a preemptible fleet, preemption is the
COMMON event, not the exception — this module is the step from "can be
resumed" (``ckpt``) to "resumes itself":

* ``PreemptionHandler`` — a SIGTERM/SIGINT (and pluggable
  maintenance-notice) handler. The signal only sets a flag; the step
  loop finishes the in-flight step, then ``RuntimeHealth.step_done``
  raises ``Preempted`` so ``fit`` cuts a final checkpoint through the
  existing ``CheckpointManager``, finalizes traces/counters, and exits
  with ``PREEMPTED_EXIT``. A grace-deadline thread hard-exits with the
  same code if the graceful path overruns the window — the manifest-last
  commit protocol makes an exit mid-save leave only an inert partial.
* ``Watchdog`` — a heartbeat thread fed by the step loop and by
  checkpoint-writer progress. When no progress lands within the
  timeout, it dumps every Python thread stack, bumps the
  ``<run>/watchdog_trip`` counter, finalizes the trace dir
  (best-effort), and ``os._exit``\\ s with ``HUNG_EXIT`` instead of
  blocking forever on a stuck collective — the ONLY way out of a hung
  gloo/NCCL rendezvous is a process exit the supervisor can classify.
* ``Supervisor`` — runs the training job as a subprocess, classifies
  exit codes (clean / kill / preempted / hung / crash), and restarts
  with ``--resume`` under a bounded exponential-backoff retry budget.

Everything time-based takes an injectable ``clock`` so the tier-1 tests
drive the watchdog and backoff with a fake clock — no real multi-second
sleeps in the suite.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from flexflow_tpu_torch.ckpt.faults import KILL_EXIT
from flexflow_tpu_torch.obs.registry import get_registry

# Distinct, supervisor-classifiable exit codes. KILL_EXIT (77) is the
# FFS_FAULT hard-kill simulation (ckpt/faults.py); these
# two are the graceful-preemption and watchdog paths. All three sit in
# the 64..113 user range so they never collide with python tracebacks
# (1) or shell signal encodings (128+N).
PREEMPTED_EXIT = 78
HUNG_EXIT = 79


class Preempted(SystemExit):
    """Raised by ``RuntimeHealth.step_done`` after the in-flight step
    finished under a preemption notice. A ``SystemExit`` subclass with
    ``code=PREEMPTED_EXIT``, so an unhandled propagation exits the
    process with the code the supervisor classifies as "preempted" —
    while ``fit``'s failure path still flushes traces on the way out."""

    def __init__(self, reason: str = "signal"):
        super().__init__(PREEMPTED_EXIT)
        self.reason = reason


def dump_thread_stacks(out=None) -> None:
    """Write every Python thread's current stack to ``out`` (stderr) —
    the post-mortem a hung collective otherwise never yields."""
    out = out or sys.stderr
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        print(f"--- thread {names.get(tid, '?')} (tid {tid}) ---",
              file=out)
        traceback.print_stack(frame, file=out)
    out.flush()


class Watchdog:
    """Trips when no heartbeat lands within ``timeout_s``.

    ``beat()`` is fed by the step loop (one beat per finished step) and
    by the checkpoint writer (a long commit is progress, not a hang).
    The polling thread calls ``check()``; a trip dumps all thread
    stacks, bumps ``<run>/watchdog_trip``, then runs ``on_trip`` —
    whose default finalizes the trace dir (best-effort) and
    ``os._exit(HUNG_EXIT)``. ``clock`` is injectable so unit tests
    drive ``check()`` directly with a fake clock.

    The watchdog ARMS on the first beat: before any progress signal
    exists there is nothing to distinguish a healthy slow startup
    (checkpoint restore, first-step JIT compile — minutes on a big
    model) from a hang, so startup never trips — a run only becomes
    reapable once it has demonstrated step-loop (or writer) progress.
    Startup/rendezvous hangs are the platform timeout's job."""

    def __init__(self, timeout_s: float, run_name: str = "fit",
                 clock: Callable[[], float] = time.monotonic,
                 on_trip: Optional[Callable[[], None]] = None,
                 finalize_fn: Optional[Callable[[], None]] = None,
                 exit_fn: Callable[[int], None] = os._exit,
                 poll_interval_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.run_name = run_name
        self._clock = clock
        self._on_trip = on_trip
        self._finalize_fn = finalize_fn
        self._exit_fn = exit_fn
        self.poll_interval_s = (poll_interval_s if poll_interval_s
                                else max(0.05, min(1.0, timeout_s / 4)))
        self._lock = threading.Lock()
        self._last_beat: Optional[float] = None  # None = not yet armed
        self._last_what = "start"
        self.tripped = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self, what: str = "step") -> None:
        with self._lock:
            self._last_beat = self._clock()
            self._last_what = what

    def seconds_since_beat(self) -> float:
        with self._lock:
            if self._last_beat is None:
                return 0.0
            return self._clock() - self._last_beat

    def check(self) -> bool:
        """One poll: returns True (and fires the trip action, once) when
        the heartbeat is older than the timeout. Never trips before the
        first beat (unarmed — see the class docstring)."""
        if self.tripped:
            return True
        with self._lock:
            if self._last_beat is None:
                return False
            stalled = self._clock() - self._last_beat
            what = self._last_what
        if stalled <= self.timeout_s:
            return False
        self.tripped = True
        print(f"[health] watchdog: no progress for {stalled:.1f}s "
              f"(timeout {self.timeout_s:.1f}s, last heartbeat: {what}) — "
              f"dumping thread stacks and exiting {HUNG_EXIT}",
              file=sys.stderr, flush=True)
        try:
            dump_thread_stacks(sys.stderr)
        except Exception:
            pass
        get_registry().inc(f"{self.run_name}/watchdog_trip")
        if self._on_trip is not None:
            self._on_trip()
        else:
            self._default_trip()
        return True

    def _default_trip(self) -> None:
        # best-effort trace/counter flush — the main thread is stuck in
        # a collective and will never reach its own finalizer
        if self._finalize_fn is not None:
            try:
                self._finalize_fn()
            except Exception as e:
                print(f"[health] watchdog trace finalize failed: {e!r}",
                      file=sys.stderr)
        self._exit_fn(HUNG_EXIT)

    # ---- polling thread ----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ffs-watchdog")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            if self.check():
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class PreemptionHandler:
    """Turns SIGTERM/SIGINT (and a pluggable maintenance notice) into a
    cooperative stop flag the step loop polls.

    The handler itself does no work — Python delivers signals between
    bytecodes on the main thread, which IS the training thread, so any
    checkpointing from the handler would race the compiled step's
    buffers. Instead ``should_stop()`` turns true and the loop takes the
    graceful path after the in-flight step. The first signal also arms
    a grace-deadline thread: if the graceful path (final checkpoint +
    trace finalize) overruns ``grace_window_s``, the process exits
    ``PREEMPTED_EXIT`` anyway — beating the platform's SIGKILL with the
    manifest-last commit protocol guaranteeing no ambiguous state. A
    second signal exits immediately (the operator's double-^C)."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, grace_window_s: float = 30.0,
                 run_name: str = "fit",
                 notice_fn: Optional[Callable[[], bool]] = None,
                 notice_poll_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 exit_fn: Callable[[int], None] = os._exit):
        self.grace_window_s = float(grace_window_s)
        self.run_name = run_name
        self.notice_fn = notice_fn
        self.notice_poll_s = float(notice_poll_s)
        self._clock = clock
        self._exit_fn = exit_fn
        self._event = threading.Event()
        self.reason: Optional[str] = None
        self._last_notice_poll = -float("inf")
        self._prev: Dict[int, Any] = {}
        self._deadline_thread: Optional[threading.Thread] = None
        self._deadline_cancel = threading.Event()
        self._announced = False

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def install(self) -> bool:
        """Install the signal handlers (main thread only — other threads
        can't own signals; returns False and stays cooperative
        via ``notice_fn``/``request_preempt`` elsewhere)."""
        try:
            for sig in self.SIGNALS:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            return True
        except ValueError:  # not the main thread
            self._prev.clear()
            print("[health] not on the main thread — preemption signals "
                  "not hooked (maintenance-notice polling still active)",
                  file=sys.stderr)
            return False

    def uninstall(self) -> None:
        # the graceful path finished (or the loop exited another way):
        # the armed deadline must not hard-exit a process that already
        # handed control back to its caller
        self._deadline_cancel.set()
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except ValueError:
                pass
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        # a flag and the grace deadline only: the announcement and the
        # registry count wait for the step loop's poll (should_stop)
        if self._event.is_set():
            # second signal: the operator insists — exit now; the
            # commit protocol keeps the last checkpoint loadable
            os.write(2, f"[health] second signal ({signum}) — exiting "
                        f"{PREEMPTED_EXIT} immediately\n".encode())
            self._exit_fn(PREEMPTED_EXIT)
            return
        self._raise_flag(f"signal:{signum}")

    def _raise_flag(self, reason: str) -> None:
        self.reason = reason
        self._event.set()
        if self.grace_window_s > 0:
            self._arm_deadline()

    def request_preempt(self, reason: str = "request") -> None:
        """The cooperative entry every source other than a signal funnels
        through: the polled maintenance notice, tests."""
        if self._event.is_set():
            return
        self._raise_flag(reason)
        self._announce()

    def _announce(self) -> None:
        """Print the notice and count it (``<run>/preemption_signal``),
        once, on the thread that polls."""
        if self._announced:
            return
        self._announced = True
        print(f"[health] preemption notice ({self.reason}): finishing the "
              f"in-flight step, then cutting a final checkpoint inside "
              f"the {self.grace_window_s:.0f}s grace window",
              file=sys.stderr, flush=True)
        get_registry().inc(f"{self.run_name}/preemption_signal")

    def _arm_deadline(self) -> None:
        if self._deadline_thread is not None:
            return
        deadline = self._clock() + self.grace_window_s

        def _enforce():
            while self._clock() < deadline:
                if self._deadline_cancel.wait(min(0.2,
                                                  self.grace_window_s)):
                    return
            print(f"[health] grace window ({self.grace_window_s:.0f}s) "
                  f"expired before the graceful path finished — exiting "
                  f"{PREEMPTED_EXIT} (a save mid-commit leaves only an "
                  f"inert partial)", file=sys.stderr, flush=True)
            self._exit_fn(PREEMPTED_EXIT)

        self._deadline_thread = threading.Thread(
            target=_enforce, daemon=True, name="ffs-grace-deadline")
        self._deadline_thread.start()

    def should_stop(self) -> bool:
        """Polled by the step loop between steps. Also time-gates the
        pluggable maintenance-notice poll (e.g. a cloud metadata
        server's upcoming-maintenance endpoint)."""
        if self._event.is_set():
            self._announce()
            return True
        if self.notice_fn is not None:
            now = self._clock()
            if now - self._last_notice_poll >= self.notice_poll_s:
                self._last_notice_poll = now
                try:
                    if self.notice_fn():
                        self.request_preempt(reason="maintenance_notice")
                except Exception as e:
                    print(f"[health] maintenance-notice poll failed: "
                          f"{e!r}", file=sys.stderr)
        return self._event.is_set()


class RuntimeHealth:
    """The one supervision object a training loop talks to.

    ``step_done(step)`` after every finished step: feeds the watchdog
    heartbeat and raises ``Preempted`` when a preemption notice is
    pending — AFTER the in-flight step, so the checkpoint the graceful
    path cuts is a consistent post-step state. ``heartbeat(what)`` is
    the side channel for checkpoint-writer progress. Use as a context
    manager (``close`` restores signal handlers and stops the watchdog
    thread)."""

    def __init__(self, grace_window_s: float = 0.0,
                 watchdog_timeout_s: float = 0.0,
                 run_name: str = "fit",
                 notice_fn: Optional[Callable[[], bool]] = None,
                 finalize_fn: Optional[Callable[[], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 exit_fn: Callable[[int], None] = os._exit,
                 start_thread: bool = True):
        self.run_name = run_name
        self.preemption: Optional[PreemptionHandler] = None
        self.watchdog: Optional[Watchdog] = None
        if grace_window_s > 0 or notice_fn is not None:
            self.preemption = PreemptionHandler(
                grace_window_s=grace_window_s or 30.0, run_name=run_name,
                notice_fn=notice_fn, clock=clock, exit_fn=exit_fn)
        if watchdog_timeout_s > 0:
            self.watchdog = Watchdog(watchdog_timeout_s, run_name=run_name,
                                     clock=clock, finalize_fn=finalize_fn,
                                     exit_fn=exit_fn)
        self._start_thread = start_thread

    @property
    def active(self) -> bool:
        return self.preemption is not None or self.watchdog is not None

    def install(self) -> "RuntimeHealth":
        if self.preemption is not None:
            self.preemption.install()
        if self.watchdog is not None and self._start_thread:
            self.watchdog.start()
        return self

    __enter__ = install

    def step_done(self, step: int) -> None:
        if self.watchdog is not None:
            self.watchdog.beat(f"step {step}")
        if self.preemption is not None and self.preemption.should_stop():
            raise Preempted(self.preemption.reason or "signal")

    def heartbeat(self, what: str = "ckpt") -> None:
        """Checkpoint-writer progress: a slow commit is not a hang."""
        if self.watchdog is not None:
            self.watchdog.beat(what)

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.preemption is not None:
            self.preemption.uninstall()

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# supervisor: classify exit codes, restart with --resume under a
# bounded exponential-backoff budget


#: exit-code -> outcome class. Anything not in the table (tracebacks,
#: OOM kills, shell signal encodings) is a crash — restartable, but
#: counted against the same budget.
EXIT_OUTCOMES = {
    0: "clean",
    KILL_EXIT: "kill",
    PREEMPTED_EXIT: "preempted",
    HUNG_EXIT: "hung",
}

RESTARTABLE = ("kill", "preempted", "hung", "crash")


def classify_exit(code: Optional[int]) -> str:
    """clean / kill / preempted / hung / crash — the supervisor's whole
    decision input. Negative codes (subprocess's signal encoding) and
    unknown positives are crashes."""
    if code is None:
        return "crash"
    return EXIT_OUTCOMES.get(int(code), "crash")


def _default_run(cmd: Sequence[str], env: Dict[str, str]) -> int:
    return subprocess.call(list(cmd), env=env)


class Supervisor:
    """Run a training command, restart it with ``--resume`` on
    restartable exits, give up when the retry budget drains.

    The first attempt keeps the caller's environment verbatim
    (including any ``FFS_FAULT`` injection — that is how the dryrun
    legs provoke the failure under test); restarts drop ``FFS_FAULT``
    unless ``keep_faults`` — an injected fault models a ONE-TIME
    environmental event, and replaying it forever would turn every
    supervised dryrun into an infinite crash loop.

    State lands in ``state_path`` (SUPERVISOR.json, atomic) after every
    attempt: restart counts by outcome and cumulative backoff downtime,
    which ``CheckpointManager.finalize`` folds into
    ``goodput_effective`` so restart time is paid in the metric, not
    hidden. ``run_fn``/``sleep_fn``/``clock`` are injectable for the
    tier-1 tests (no subprocesses, no real sleeps)."""

    def __init__(self, cmd: Sequence[str], max_restarts: int = 3,
                 backoff_base_s: float = 1.0, backoff_max_s: float = 60.0,
                 resume_flag: str = "--resume",
                 state_path: Optional[str] = None,
                 keep_faults: bool = False,
                 env: Optional[Dict[str, str]] = None,
                 run_fn: Callable[..., int] = _default_run,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if not cmd:
            raise ValueError("supervisor needs a training command")
        self.cmd = list(cmd)
        self.max_restarts = max(0, int(max_restarts))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.resume_flag = resume_flag
        self.state_path = state_path
        self.keep_faults = keep_faults
        self.env = dict(env if env is not None else os.environ)
        self._run_fn = run_fn
        self._sleep_fn = sleep_fn
        self._clock = clock

    def backoff_s(self, restart_index: int) -> float:
        """Bounded exponential: base * 2^i capped at max."""
        return min(self.backoff_max_s,
                   self.backoff_base_s * (2.0 ** restart_index))

    def _child_cmd(self, attempt: int) -> List[str]:
        if attempt == 0 or self.resume_flag in self.cmd:
            return list(self.cmd)
        return list(self.cmd) + [self.resume_flag]

    def _child_env(self, attempt: int) -> Dict[str, str]:
        env = dict(self.env)
        if attempt > 0 and not self.keep_faults:
            env.pop("FFS_FAULT", None)
        return env

    def run(self) -> Dict[str, Any]:
        """Supervise to completion. Returns the summary dict (also the
        state-file payload): ``final_code``, ``final_outcome``,
        ``attempts``, ``restarts``, ``outcomes`` (counts by class),
        ``downtime_s``, ``history``."""
        history: List[Dict[str, Any]] = []
        outcomes: Dict[str, int] = {}
        downtime = 0.0
        attempt = 0
        while True:
            cmd = self._child_cmd(attempt)
            t0 = self._clock()
            code = self._run_fn(cmd, self._child_env(attempt))
            outcome = classify_exit(code)
            history.append(dict(attempt=attempt, code=code,
                                outcome=outcome,
                                duration_s=self._clock() - t0,
                                resumed=attempt > 0))
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
            summary = dict(final_code=code, final_outcome=outcome,
                           attempts=attempt + 1, restarts=attempt,
                           outcomes=outcomes, downtime_s=downtime,
                           history=history)
            self._write_state(summary)
            if outcome == "clean":
                return summary
            if outcome not in RESTARTABLE or attempt >= self.max_restarts:
                print(f"[supervise] giving up after {attempt + 1} "
                      f"attempt(s): exit {code} ({outcome}), "
                      f"{self.max_restarts} restart budget",
                      file=sys.stderr, flush=True)
                return summary
            delay = self.backoff_s(attempt)
            print(f"[supervise] attempt {attempt} exited {code} "
                  f"({outcome}) — restarting with {self.resume_flag} in "
                  f"{delay:.1f}s ({self.max_restarts - attempt} "
                  f"restart(s) left)", file=sys.stderr, flush=True)
            t0 = self._clock()
            self._sleep_fn(delay)
            downtime += self._clock() - t0
            attempt += 1
            # re-persist AFTER the backoff so the child launched next
            # reads a downtime_s/restarts view that includes the wait
            # that just preceded it (its finalize folds this into
            # goodput_effective mid-run)
            summary = dict(summary, restarts=attempt, downtime_s=downtime)
            self._write_state(summary)

    def _write_state(self, summary: Dict[str, Any]) -> None:
        if not self.state_path:
            return
        from flexflow_tpu_torch.ckpt import manifest as mf
        payload = dict(summary, wall_unix=time.time(), cmd=self.cmd)
        try:
            mf.atomic_write_json(self.state_path, payload)
        except OSError as e:
            print(f"[supervise] state write failed: {e!r}",
                  file=sys.stderr)
