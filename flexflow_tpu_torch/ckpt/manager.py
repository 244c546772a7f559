"""CheckpointManager: async cadence, retain-N GC, resume, goodput.

PyTorch counterpart of ``flexflow_tpu/ckpt/manager.py``, with the same
registry names. The writer thread touches host numpy only, never a CUDA
tensor: the snapshot hands it host copies.

The training loop's one checkpoint object (``fit(checkpoint_dir=...)``
builds it). Split of labor per save:

* on the training thread: ``snapshot()`` — the device→host copy of this
  host's shards. This is the ONLY blocking cost the hot loop pays
  (observed as ``<run>/ckpt_save_stall_s``); it must finish before the
  next step runs, because the compiled step rewrites the very buffers
  being read.
* on the writer thread: serialization, checksums, the tmp+rename file
  writes, the manifest commit barrier, and retain-N garbage collection
  (``<run>/ckpt_async_write_s``, ``<run>/ckpt_bytes_written``).

Saves are serialized (a new save joins the previous writer first), and
writer errors are re-raised on the training thread at the next
``save``/``finalize`` — a checkpoint that silently failed to commit is
worse than a loud crash.

Goodput accounting: ``finalize`` publishes ``<run>/goodput_effective``
= productive time / (wall + restart-lost time + supervisor downtime),
where checkpoint stalls count against the numerator, the steps lost to
the last preemption (restored iteration vs the rank-0 PROGRESS
heartbeat) are priced at the run's own mean step time, and the restart
backoff a ``runtime_health.Supervisor`` session spent (SUPERVISOR.json's
``downtime_s``) lands in the denominator. This is the ratchet
coordinate for the elastic-training direction.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

from flexflow_tpu_torch.ckpt import manifest as mf
from flexflow_tpu_torch.ckpt import sharded
from flexflow_tpu_torch.obs.registry import get_registry

_PROGRESS_INTERVAL_S = 0.5


class CheckpointManager:
    def __init__(self, ffmodel, directory: str, every: int = 0,
                 retain: int = 3, async_write: bool = True,
                 run_name: str = "fit", fs_timeout: float = 120.0,
                 heartbeat=None, state_provider=None):
        if not directory:
            raise ValueError("CheckpointManager needs a checkpoint directory")
        self.ff = ffmodel
        self.directory = str(directory)
        self.every = int(every)
        self.retain = max(1, int(retain))
        self.async_write = bool(async_write)
        self.run_name = run_name
        self.fs_timeout = float(fs_timeout)
        # watchdog feed (runtime_health.py): writer-thread
        # progress marks — a long commit is progress, not a hang
        self.heartbeat = heartbeat
        # JSON-able client state recorded in every manifest (the
        # dataloader cursor travels here; fit_loader sets it)
        self.state_provider = state_provider
        self.restart_lost_steps = 0
        self._last_saved_iter = -1
        self._stall_total_s = 0.0
        self._pending: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self._last_progress = 0.0
        self._rank = sharded.process_index_count()[0]
        os.makedirs(self.directory, exist_ok=True)

    # ---- resume ------------------------------------------------------------
    def resume(self, require: bool = False) -> int:
        """Restore the newest complete checkpoint, if any.

        Returns the restored iteration (0 when the directory holds no
        checkpoint at all — a fresh launch under the same command line).
        A directory that has step dirs but NO complete checkpoint, or a
        corrupt one, raises on every rank; ``require=True`` also makes
        an empty directory an error."""
        t0 = time.perf_counter()
        has_steps = bool(mf.list_steps(self.directory))
        if not has_steps and not require:
            return 0  # fresh start (every rank sees an empty directory)
        # missing/partial fails fast (load_sharded)
        it = sharded.load_sharded(self.directory, self.ff)
        self._last_saved_iter = it
        reg = get_registry()
        reg.gauge(f"{self.run_name}/ckpt_restore_s",
                  time.perf_counter() - t0)
        progress = mf.read_progress(self.directory)
        if progress > it:
            self.restart_lost_steps = progress - it
            reg.gauge(f"{self.run_name}/ckpt_restart_lost_steps",
                      self.restart_lost_steps)
        return it

    # ---- cadence -----------------------------------------------------------
    def should_save(self, iteration: int) -> bool:
        return (self.every > 0 and iteration > self._last_saved_iter
                and iteration % self.every == 0)

    def note_step(self, iteration: int) -> None:
        """Rank-0 progress heartbeat (time-gated atomic write) so a
        resume can price the steps the preemption threw away."""
        if self._rank != 0:
            return
        now = time.monotonic()
        if now - self._last_progress < _PROGRESS_INTERVAL_S:
            return
        self._last_progress = now
        try:
            mf.note_progress(self.directory, iteration)
        except OSError as e:
            print(f"[ckpt] progress heartbeat failed: {e!r}",
                  file=sys.stderr)

    # ---- save --------------------------------------------------------------
    def save(self, iteration: Optional[int] = None) -> None:
        """Snapshot on the calling thread, commit async (or inline when
        ``async_write=False``). Raises a previous writer error here
        rather than losing it. The stall gauge starts BEFORE the join
        with the previous writer: when the writer is slower than the
        save cadence, that join blocks the hot loop and must show up in
        ``ckpt_save_stall_s``/goodput — the exact regime the metric
        exists to expose."""
        t0 = time.perf_counter()
        self._join_pending()
        client_state = None
        if self.state_provider is not None:
            try:
                client_state = self.state_provider()
            except Exception as e:
                print(f"[ckpt] state_provider failed (manifest will carry "
                      f"no client_state): {e!r}", file=sys.stderr)
        snap = sharded.snapshot(self.ff, step=iteration,
                                client_state=client_state)
        self._last_saved_iter = snap.step
        if self.async_write:
            self._pending = threading.Thread(
                target=self._commit, args=(snap,), daemon=True,
                name=f"ckpt-writer-step{snap.step}")
            self._pending.start()
        else:
            # inline commit blocks the training thread — that cost
            # belongs in the stall too
            self._commit(snap)
        stall = time.perf_counter() - t0
        self._stall_total_s += stall
        get_registry().observe(f"{self.run_name}/ckpt_save_stall_s", stall)
        if not self.async_write:
            self._raise_writer_error()
        self.note_step(snap.step)

    def _commit(self, snap) -> None:
        t0 = time.perf_counter()
        try:
            if self.heartbeat is not None:
                self.heartbeat(f"ckpt commit start step {snap.step}")
            nbytes = sharded.write_snapshot(self.directory, snap,
                                            fs_timeout=self.fs_timeout,
                                            heartbeat=self.heartbeat)
            reg = get_registry()
            reg.observe(f"{self.run_name}/ckpt_async_write_s",
                        time.perf_counter() - t0)
            reg.inc(f"{self.run_name}/ckpt_saves")
            reg.inc(f"{self.run_name}/ckpt_bytes_written", nbytes)
            if self._rank == 0:
                mf.collect_garbage(self.directory, self.retain)
        except BaseException as e:  # surfaces at next save()/finalize()
            self._writer_error = e
            print(f"[ckpt] checkpoint write for step {snap.step} failed: "
                  f"{e!r}", file=sys.stderr)

    def _join_pending(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._raise_writer_error()

    def _raise_writer_error(self) -> None:
        if self._writer_error is not None:
            e, self._writer_error = self._writer_error, None
            raise RuntimeError(
                f"asynchronous checkpoint write failed: {e!r}") from e

    # ---- durability barrier / teardown ------------------------------------
    def wait(self) -> None:
        """Durability barrier: returns only once every enqueued save is
        committed (manifest visible). Raises if the writer failed."""
        self._join_pending()

    def finalize(self, elapsed_s: Optional[float] = None,
                 steps: Optional[int] = None,
                 final_save: bool = True) -> None:
        """End-of-run: final checkpoint (when the last step isn't already
        saved), durability barrier, goodput gauge. The final save does
        NOT require a cadence: ``checkpoint_dir`` without
        ``checkpoint_every`` means "checkpoint once, at the end" — a
        configured directory that a whole run leaves empty would be a
        silent data-loss trap at the next ``--resume``."""
        if (final_save
                and self.ff._iter > max(self._last_saved_iter, 0)):
            self.save(self.ff._iter)
        self._join_pending()
        if elapsed_s and steps:
            productive = max(0.0, elapsed_s - self._stall_total_s)
            per_step = productive / max(1, steps)
            lost_s = self.restart_lost_steps * per_step
            # a run living under a Supervisor also pays the
            # supervisor's restart backoff — that downtime belongs in
            # the goodput denominator, not hidden outside the metric
            reg = get_registry()
            sup_downtime = 0.0
            sup = mf.read_supervisor(self.directory)
            if sup:
                sup_downtime = float(sup.get("downtime_s") or 0.0)
                reg.gauge(f"{self.run_name}/supervisor_restarts",
                          float(sup.get("restarts") or 0))
                reg.gauge(f"{self.run_name}/supervisor_downtime_s",
                          sup_downtime)
            goodput = productive / max(elapsed_s + lost_s + sup_downtime,
                                       1e-12)
            reg.gauge(f"{self.run_name}/goodput_effective",
                      max(0.0, min(1.0, goodput)))

    @property
    def save_stall_s(self) -> float:
        return self._stall_total_s
