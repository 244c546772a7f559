"""Deterministic fault injection for the elastic-training harness.

The PyTorch port's copy of ``flexflow_tpu/ckpt/faults.py``: the same
``FFS_FAULT`` grammar, exit codes and seams. A process's rank is its
``torch.distributed`` rank when a process group is initialised, else 0.

``FFS_FAULT`` holds a comma-separated list of fault specs; each names
an injection seam the checkpoint/runtime code calls at well-defined
points, so a dryrun can kill a host mid-epoch, corrupt a shard on disk,
slow the writer, deliver a preemption signal, wedge the step loop, or
make checkpoint writes fail transiently — deterministically, without
patching internals:

* ``kill_host:<rank>@step:<n>`` — process ``rank`` exits hard (no
  cleanup, exit code ``KILL_EXIT``) right after finishing global step
  ``n`` — the hardware-loss simulation. Seam: ``step_hook(step)``.
* ``sigterm:<rank>@step:<n>`` — process ``rank`` sends ITSELF SIGTERM
  after finishing step ``n`` — the platform-preemption simulation the
  grace-window path (flexflow_tpu_torch/runtime_health.py) must convert into
  a final checkpoint plus a ``PREEMPTED_EXIT``. Fires once. Seam:
  ``step_hook(step)``.
* ``hang:<rank>@step:<n>`` — process ``rank`` blocks the step loop
  after finishing step ``n`` (the stuck-collective simulation) until
  the watchdog ``os._exit``\\ s it with ``HUNG_EXIT``. Bounded at
  ``HANG_LIMIT_S`` so a missing watchdog turns into a loud error, not
  a silent CI hang. Seam: ``step_hook(step)``.
* ``corrupt_shard:<key_substr>@step:<n>`` — during the save of step
  ``n``, the serialized bytes of the first shard whose leaf path
  contains ``key_substr`` are bit-flipped AFTER its checksum was
  computed — the on-disk rot the integrity verifier must catch. Seam:
  ``corrupt_bytes(leaf_key, step, payload)``.
* ``slow_write:<ms>`` — every shard-file write sleeps ``ms``
  milliseconds first; exaggerates the writer latency so the async-path
  tests can prove the hot loop does not pay it. Seam: ``write_delay()``.
* ``io_error:<path_substr>:<count>`` — the next ``count`` atomic file
  writes whose destination path contains ``path_substr`` raise
  ``OSError(EIO)`` — the transient-filesystem blip the checkpoint
  writers must absorb with retry-with-backoff
  (ckpt/sharded.py). Seam: ``io_check(path)`` inside
  ``manifest.atomic_replace``.

Parsing is cached per env-string so the per-step hook costs one dict
lookup when ``FFS_FAULT`` is unset.
"""

from __future__ import annotations

import errno
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

ENV = "FFS_FAULT"
KILL_EXIT = 77  # distinguishable from python tracebacks (1) and signals

# a hang fault without a watchdog must fail loudly, not wedge CI forever
HANG_LIMIT_S = 900.0


class FaultPlan:
    def __init__(self, kills: List[Tuple[int, int]],
                 corrupts: List[Tuple[str, int]],
                 slow_write_s: float,
                 sigterms: Optional[List[Tuple[int, int]]] = None,
                 hangs: Optional[List[Tuple[int, int]]] = None,
                 io_errors: Optional[List[List]] = None):
        self.kills = kills            # [(rank, step)]
        self.corrupts = corrupts      # [(key_substr, step)]
        self.slow_write_s = slow_write_s
        self.sigterms = sigterms or []  # [(rank, step)]
        self.hangs = hangs or []        # [(rank, step)]
        # [[path_substr, remaining_count], ...] — mutable: each injected
        # failure decrements its budget (the "transient" in transient
        # I/O error)
        self.io_errors = io_errors or []
        self._corrupted = set()       # fire each corrupt spec once
        self._sigtermed = set()       # fire each sigterm spec once

    def _rank(self) -> int:
        import torch.distributed as dist
        return (dist.get_rank()
                if dist.is_available() and dist.is_initialized() else 0)

    def step_hook(self, step: int) -> None:
        if not (self.kills or self.sigterms or self.hangs):
            return
        rank = self._rank()
        for (r, s) in self.kills:
            if r == rank and s == step:
                print(f"[ffs_fault] kill_host: rank {rank} exiting at "
                      f"step {step}", file=sys.stderr, flush=True)
                os._exit(KILL_EXIT)
        for i, (r, s) in enumerate(self.sigterms):
            if r == rank and s == step and i not in self._sigtermed:
                self._sigtermed.add(i)
                print(f"[ffs_fault] sigterm: rank {rank} raising SIGTERM "
                      f"on itself at step {step}", file=sys.stderr,
                      flush=True)
                import signal
                os.kill(os.getpid(), signal.SIGTERM)
        for (r, s) in self.hangs:
            if r == rank and s == step:
                print(f"[ffs_fault] hang: rank {rank} wedging the step "
                      f"loop at step {step} (watchdog must reap this "
                      f"process)", file=sys.stderr, flush=True)
                deadline = time.monotonic() + HANG_LIMIT_S
                while time.monotonic() < deadline:
                    time.sleep(0.1)
                raise RuntimeError(
                    f"FFS_FAULT hang at step {step} expired after "
                    f"{HANG_LIMIT_S:.0f}s without a watchdog reaping the "
                    f"process — set --watchdog-timeout when injecting "
                    f"hang faults")

    def corrupt_bytes(self, leaf_key: str, step: int,
                      payload: bytes) -> bytes:
        for i, (sub, s) in enumerate(self.corrupts):
            if s == step and sub in leaf_key and i not in self._corrupted:
                self._corrupted.add(i)
                print(f"[ffs_fault] corrupt_shard: flipping a byte of "
                      f"'{leaf_key}' at step {step}", file=sys.stderr,
                      flush=True)
                b = bytearray(payload)
                b[len(b) // 2] ^= 0xFF
                return bytes(b)
        return payload

    def write_delay(self) -> None:
        if self.slow_write_s > 0:
            time.sleep(self.slow_write_s)

    def io_check(self, path: str) -> None:
        """Transient-write seam: raise EIO while a matching io_error
        spec still has failure budget (each raise spends one)."""
        for spec in self.io_errors:
            sub, remaining = spec
            if remaining > 0 and sub in path:
                spec[1] = remaining - 1
                print(f"[ffs_fault] io_error: failing write of "
                      f"'{os.path.basename(path)}' ({remaining - 1} "
                      f"failure(s) left for {sub!r})", file=sys.stderr,
                      flush=True)
                raise OSError(errno.EIO,
                              f"FFS_FAULT injected I/O error", path)


def _parse(spec: str) -> Optional[FaultPlan]:
    kills: List[Tuple[int, int]] = []
    corrupts: List[Tuple[str, int]] = []
    sigterms: List[Tuple[int, int]] = []
    hangs: List[Tuple[int, int]] = []
    io_errors: List[List] = []
    slow = 0.0
    for part in filter(None, (p.strip() for p in spec.split(","))):
        try:
            head, _, tail = part.partition("@")
            kind, _, arg = head.partition(":")
            if kind == "kill_host":
                kills.append((int(arg), _step_of(tail)))
            elif kind == "sigterm":
                sigterms.append((int(arg), _step_of(tail)))
            elif kind == "hang":
                hangs.append((int(arg), _step_of(tail)))
            elif kind == "corrupt_shard":
                corrupts.append((arg, _step_of(tail)))
            elif kind == "slow_write":
                slow = float(arg) / 1e3
            elif kind == "io_error":
                if tail:
                    raise ValueError("io_error takes no @step")
                sub, sep, cnt = arg.rpartition(":")
                if not sep or not sub:
                    raise ValueError(
                        "io_error needs <path_substr>:<count>")
                n = int(cnt)
                if n < 1:
                    raise ValueError(f"io_error count must be >= 1, "
                                     f"got {n}")
                io_errors.append([sub, n])
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
        except (ValueError, IndexError) as e:
            raise ValueError(
                f"{ENV}={spec!r}: cannot parse fault {part!r} "
                f"(expected kill_host:<rank>@step:<n>, "
                f"sigterm:<rank>@step:<n>, hang:<rank>@step:<n>, "
                f"corrupt_shard:<key>@step:<n>, slow_write:<ms>, or "
                f"io_error:<path_substr>:<count>): {e}"
            ) from None
    if not (kills or corrupts or sigterms or hangs or io_errors or slow):
        return None
    return FaultPlan(kills, corrupts, slow, sigterms=sigterms,
                     hangs=hangs, io_errors=io_errors)


def _step_of(tail: str) -> int:
    kind, _, v = tail.partition(":")
    if kind != "step":
        raise ValueError(f"expected @step:<n>, got @{tail!r}")
    return int(v)


_CACHE: Dict[str, Optional[FaultPlan]] = {}


def get_plan() -> Optional[FaultPlan]:
    """The active fault plan (None when ``FFS_FAULT`` is unset/empty).
    Re-reads the env each call; parsing is memoized per spec string."""
    spec = os.environ.get(ENV, "")
    if not spec:
        return None
    if spec not in _CACHE:
        _CACHE[spec] = _parse(spec)
    return _CACHE[spec]


def step_hook(step: int) -> None:
    """Per-training-step seam (kill_host / sigterm / hang). No-op
    without ``FFS_FAULT``."""
    plan = get_plan()
    if plan is not None:
        plan.step_hook(step)


def io_check(path: str) -> None:
    """Per-atomic-write seam (io_error). No-op without ``FFS_FAULT``."""
    plan = get_plan()
    if plan is not None:
        plan.io_check(path)
