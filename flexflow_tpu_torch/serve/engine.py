"""ServingEngine: per-bucket executors + continuous batching.

PyTorch counterpart of ``flexflow_tpu/serve/engine.py``. The layer graph
re-materializes at each batch bucket (1, 2, 4, ... up to the declared
batch) over the model's shared parameters, and the ``serve/batching``
scheduler runs over the bucket executors: requests queue, close on
size-or-deadline, pad into the smallest bucket that fits, and
per-request rows come back out. p50/p99 request latency, queue depth and
batch occupancy flow through the port's obs registry (``serve/*``).

Every bucket reuses the model's single-device placement (objective
"reused-training-strategy", the reference's behaviour at search budget
0). The per-bucket latency search comes with the search slice.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.obs.registry import get_registry
from flexflow_tpu_torch.serve.batching import (BatchScheduler, Request,
                                               RequestQueue, pad_to_bucket,
                                               pick_bucket)


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to (and including) the declared batch size."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(sorted(set(out)))


@dataclasses.dataclass
class BucketExecutor:
    """One batch bucket's forward path + its provenance."""

    bucket: int
    executor: Any  # GraphExecutor (comp_mode INFERENCE)
    objective: str
    # the attention core each op runs in this bucket ({op name -> impl}),
    # recorded at build time from the ops' selected_impl
    kernel_choices: Dict[str, str] = dataclasses.field(default_factory=dict)
    _fwd: Any = None

    def forward(self):
        if self._fwd is None:
            self._fwd = self.executor.make_forward(training=False)
        return self._fwd


class ServingEngine:
    """Continuous-batching inference server over per-bucket executors.
    Build via ``FFModel.serve()``.

    Synchronous use: ``submit()`` requests then ``step()`` (or
    ``pump()``) on the caller's thread. Background use: ``start()``
    spins the serving thread; ``submit(...).wait()`` from any number of
    client threads; ``stop()`` drains and joins.
    """

    def __init__(self, ff, batch_buckets: Optional[Sequence[int]] = None,
                 max_wait_ms: float = 5.0,
                 search_budget: Optional[int] = None,
                 verbose: bool = False):
        self.ff = ff
        max_batch = int(ff.input_tensors[0].shape[0])
        buckets = tuple(sorted({int(b) for b in
                                (batch_buckets or default_buckets(max_batch))
                                if 0 < int(b) <= max_batch}))
        if not buckets:
            raise ValueError(f"no usable batch buckets <= {max_batch}")
        budget = (search_budget if search_budget is not None
                  else getattr(ff.config, "search_budget", 0))
        if budget:
            raise NotImplementedError(
                f"search_budget={budget}: the per-bucket latency search "
                f"comes with the search slice of the PyTorch port (slice 3)")
        self.queue = RequestQueue()
        self.scheduler = BatchScheduler(buckets, max_wait_s=max_wait_ms / 1e3)
        self.verbose = verbose
        # False keeps served requests out of the registry latency
        # reservoir (loadgen toggles it off during warmup)
        self.record_latency = True
        self.buckets: Dict[int, BucketExecutor] = {
            b: self._build_bucket(b) for b in buckets}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- bucket construction ----------------------------------------------
    def _build_bucket(self, bucket: int) -> BucketExecutor:
        from flexflow_tpu_torch.executor import GraphExecutor

        ff = self.ff
        # batch-only overrides: dim 0 of every INPUT becomes the bucket
        overrides = {}
        for layer in ff.layers:
            if layer.op_type != OperatorType.INPUT:
                continue
            shp = list(layer.outputs[0].shape)
            if shp and shp[0] != bucket:
                shp[0] = bucket
                overrides[layer.name] = tuple(shp)
        nodes, input_names, tensor_ref = ff._materialize_nodes(overrides)
        final_ref = ff._select_final_ref(nodes, tensor_ref)
        full = ff.executor
        ex = GraphExecutor(nodes, input_names, final_ref, full.device,
                           compute_dtype=full.compute_dtype, mesh=full.mesh)
        mesh_axes = full.mesh.shape if full.mesh is not None else None
        kernel_choices = {n.op.name: n.op.selected_impl(full.device, mesh_axes)
                          for n in nodes if hasattr(n.op, "selected_impl")}
        be = BucketExecutor(bucket=bucket, executor=ex,
                            objective="reused-training-strategy",
                            kernel_choices=kernel_choices)
        if self.verbose:
            print(f"[serve] bucket {bucket}: objective={be.objective} "
                  f"device={full.device}", file=sys.stderr)
        return be

    # ---- request path ------------------------------------------------------
    def submit(self, inputs) -> Request:
        """Enqueue one request. ``inputs``: one array per model input,
        WITHOUT the batch dim (a single sample)."""
        return self.queue.submit(
            inputs if isinstance(inputs, (list, tuple)) else [inputs])

    def _stage(self, be: BucketExecutor, arrays: List[np.ndarray]):
        from flexflow_tpu_torch.model import stage_array

        ex = be.executor
        return {name: stage_array(arr, ex.device, ex.compute_dtype)
                for name, arr in zip(ex.input_names, arrays)}

    def _serve_batch(self, batch: List[Request]) -> None:
        t0 = time.perf_counter()
        bucket = pick_bucket(len(batch), self.scheduler.buckets)
        be = self.buckets[bucket]
        try:
            arrays = pad_to_bucket(batch, bucket)
            inputs = self._stage(be, arrays)
            fwd = be.forward()
            self.ff._refresh_compute_params()
            out = fwd(self.ff.params, self.ff.state, inputs)
            out = out.float().cpu().numpy()
            for i, req in enumerate(batch):
                req.finish(result=out[i], record=self.record_latency)
        except BaseException as e:
            for req in batch:
                if not req.done:
                    req.finish(error=e)
            raise
        finally:
            get_registry().observe(f"serve/bucket{bucket}/batch_latency_s",
                                   time.perf_counter() - t0)

    def step(self, flush: bool = False) -> int:
        """Close and serve at most one batch; returns requests served."""
        batch = self.scheduler.poll(self.queue, flush=flush)
        if not batch:
            return 0
        self._serve_batch(batch)
        return len(batch)

    def pump(self, flush: bool = True) -> int:
        """Serve until the queue drains; returns requests served."""
        total = 0
        while True:
            n = self.step(flush=flush)
            if n == 0 and self.queue.depth() == 0:
                return total
            total += n

    # ---- background serving loop ------------------------------------------
    def start(self) -> "ServingEngine":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    served = self.step()
                except Exception as e:
                    # the failed batch's requests already carry the error
                    # (_serve_batch finishes them before re-raising); the
                    # serving thread itself must survive
                    print(f"[serve] batch failed: {e!r} — serving "
                          f"continues", file=sys.stderr)
                    get_registry().inc("serve/batch_errors")
                    continue
                if served == 0:
                    # nothing closed: nap until a request arrives or the
                    # oldest hits its deadline
                    self.queue.wait_nonempty(self.scheduler.max_wait_s)
                    if self.queue.depth() and not self._stop.is_set():
                        time.sleep(min(self.scheduler.max_wait_s, 0.001))
            # drain on shutdown so no submitted request hangs forever
            while True:
                try:
                    if not self.step(flush=True):
                        break
                except Exception:
                    get_registry().inc("serve/batch_errors")
                    continue  # drained requests carry their errors

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serve-engine")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        # a request enqueued after the serving thread's final drain poll
        # is served here, so no submit that happened-before stop() hangs
        while True:
            try:
                if not self.step(flush=True):
                    break
            except Exception:
                get_registry().inc("serve/batch_errors")
                continue  # the batch's requests carry the error

    # ---- introspection -----------------------------------------------------
    def bucket_report(self) -> Dict[str, Any]:
        """Per-bucket provenance."""
        return {str(b): dict(objective=be.objective,
                             device=str(be.executor.device),
                             kernel_choices=dict(be.kernel_choices))
                for b, be in self.buckets.items()}
