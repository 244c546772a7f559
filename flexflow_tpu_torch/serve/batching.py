"""Continuous/dynamic batching: request queue + size-or-deadline scheduler.

PyTorch port's copy of ``flexflow_tpu/serve/batching.py``. Serving traffic
arrives one request at a time; the bucket executors want fixed batch
shapes. The scheduler in between closes a batch when either

* enough requests are waiting to fill the largest bucket (size close), or
* the oldest waiting request has aged past ``max_wait_s`` (deadline
  close) — latency SLOs bound how long a lone request may wait for
  company;

then pads the closed batch up to the smallest bucket that fits and
returns per-request results sliced back out of the padded batch output.

This module is pure scheduling (numpy + threads): the engine owns the
executors. Everything is observable through the port's obs registry:
``serve/queue_depth`` (gauge), ``serve/request_latency_s`` and
``serve/batch_occupancy`` (reservoir observations feeding p50/p99),
``serve/batches`` / ``serve/requests`` / ``serve/padded_rows`` counters.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from flexflow_tpu_torch.obs.registry import get_registry


class Request:
    """One in-flight inference request.

    ``inputs``: list of per-sample numpy arrays, one per model input,
    WITHOUT the batch dim (the scheduler stacks them). ``wait()`` blocks
    until the serving loop publishes ``result`` (per-request output rows,
    batch dim stripped) or ``error``.
    """

    _ids = itertools.count()

    def __init__(self, inputs: Sequence[np.ndarray]):
        self.id = next(Request._ids)
        self.inputs = [np.asarray(x) for x in inputs]
        self.enqueue_t = time.perf_counter()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.latency_s: Optional[float] = None
        self._done = threading.Event()

    def finish(self, result=None, error=None, record: bool = True) -> None:
        """``record=False`` keeps this request out of the registry's
        latency reservoir (warmup requests pay first-call costs — deploy
        cost, not serving latency; see loadgen's warmup exclusion)."""
        self.latency_s = time.perf_counter() - self.enqueue_t
        self.result = result
        self.error = error
        if error is not None:
            get_registry().inc("serve/request_errors")
        elif record:
            get_registry().observe("serve/request_latency_s", self.latency_s)
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not served in {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result

    @property
    def done(self) -> bool:
        return self._done.is_set()


class RequestQueue:
    """Thread-safe FIFO of pending Requests with a depth gauge."""

    def __init__(self):
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Event()

    def submit(self, inputs: Sequence[np.ndarray]) -> Request:
        req = Request(inputs)
        with self._lock:
            self._q.append(req)
            depth = len(self._q)
            self._nonempty.set()
        reg = get_registry()
        reg.gauge("serve/queue_depth", depth)
        reg.inc("serve/requests")
        return req

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def oldest_age_s(self, now: Optional[float] = None) -> Optional[float]:
        with self._lock:
            if not self._q:
                return None
            return (now or time.perf_counter()) - self._q[0].enqueue_t

    def pop_up_to(self, n: int) -> List[Request]:
        out: List[Request] = []
        with self._lock:
            while self._q and len(out) < n:
                out.append(self._q.popleft())
            depth = len(self._q)
            if not self._q:
                self._nonempty.clear()
        get_registry().gauge("serve/queue_depth", depth)
        return out

    def wait_nonempty(self, timeout: float) -> bool:
        return self._nonempty.wait(timeout)


def pick_bucket(count: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``count`` requests (the largest bucket
    when none does — the caller caps ``count`` at max(buckets))."""
    for b in sorted(buckets):
        if count <= b:
            return b
    return max(buckets)


class BatchScheduler:
    """Size-or-deadline batch closing over a RequestQueue.

    ``poll`` returns the Requests of one closed batch (possibly empty
    when nothing is ready yet). A batch closes when the queue can fill
    the largest bucket, when the oldest request has waited
    ``max_wait_s``, or unconditionally under ``flush=True`` (drain at
    shutdown / closed-loop bench tails).
    """

    def __init__(self, buckets: Sequence[int], max_wait_s: float = 0.005):
        if not buckets or any(int(b) <= 0 for b in buckets):
            raise ValueError(f"batch buckets must be positive, got {buckets}")
        self.buckets = tuple(sorted(int(b) for b in set(buckets)))
        self.max_batch = self.buckets[-1]
        self.max_wait_s = float(max_wait_s)

    def poll(self, queue: RequestQueue, flush: bool = False,
             now: Optional[float] = None) -> List[Request]:
        depth = queue.depth()
        if depth == 0:
            return []
        if depth >= self.max_batch or flush:
            return queue.pop_up_to(self.max_batch)
        age = queue.oldest_age_s(now)
        if age is not None and age >= self.max_wait_s:
            return queue.pop_up_to(self.max_batch)
        return []


def pad_to_bucket(requests: List[Request], bucket: int
                  ) -> List[np.ndarray]:
    """Stack each input position across ``requests`` and zero-pad the
    batch dim up to ``bucket`` rows. Returns one array per model input,
    shaped ``[bucket, ...]``; rows beyond ``len(requests)`` are padding
    the caller slices off the output."""
    if not requests:
        raise ValueError("cannot pad an empty batch")
    if len(requests) > bucket:
        raise ValueError(f"{len(requests)} requests exceed bucket {bucket}")
    n_in = len(requests[0].inputs)
    out = []
    for j in range(n_in):
        rows = [r.inputs[j] for r in requests]
        stacked = np.stack(rows, axis=0)
        if len(requests) < bucket:
            pad = np.zeros((bucket - len(requests),) + stacked.shape[1:],
                           dtype=stacked.dtype)
            stacked = np.concatenate([stacked, pad], axis=0)
        out.append(stacked)
    reg = get_registry()
    reg.inc("serve/batches")
    reg.inc("serve/padded_rows", bucket - len(requests))
    reg.observe("serve/batch_occupancy", len(requests) / bucket)
    return out
