"""ServingEngine: latency-searched per-bucket executors + continuous batching.

PyTorch counterpart of ``flexflow_tpu/serve/engine.py``. The layer graph
re-materializes at each batch bucket (1, 2, 4, ... up to the declared
batch) over the model's shared parameters. With a search budget each
bucket runs ``graph_optimize`` in INFERENCE mode, so the search minimizes
the simulated per-batch latency at that bucket's shapes (forward cost
only: no gradient sync, ``_wus`` or optimizer-state terms); the objective
(``latency@batch<N>``), the predicted latency and the kernel each op runs
are recorded per bucket. Each bucket takes ``apply_strategy``'s
"chosen" kernel rule, the reference's: a ``_k:`` choice pins its kernel,
and an attention op the search left at ``rep`` runs the flash core
wherever it can, although the search priced it at the einsum core. A
bucket whose search fails reuses the model's
strategy and says so on stderr, as the reference does. Without a budget
every bucket reuses the model's strategy ("reused-training-strategy").

Each bucket runs the model's layout pass and its compiled forward
(``GraphExecutor.make_forward``, Conv+BN pairs folded unless the model
turned the fold off):
on the card one CUDA-graph replay a batch, captured when the engine is
built, before ``start()`` launches the serving thread (in the
"thread_local" capture mode, so client threads never meet a capture); a
batch is padded on the host and copied through the graph's pinned
buffer into its static input, and its output is copied to the host
before the next replay. On the CPU the same forward runs eagerly.

The ``serve/batching`` scheduler runs over the bucket executors: requests
queue, close on size-or-deadline, pad into the smallest bucket that fits,
and per-request rows come back out. p50/p99 request latency, queue depth,
batch occupancy and each bucket's predicted latency flow through the
port's obs registry (``serve/*``).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import CompMode, OperatorType
from flexflow_tpu_torch.model import host_copy, host_input
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


def _sanitize_output_specs(nodes, mesh) -> None:
    """Null spec entries whose mesh-axis degree doesn't divide the
    bucket-materialized dim (a training strategy's 'data' on the batch
    dim is illegal at buckets below the data degree); the dim stays
    replicated for that bucket."""
    axes = mesh.shape
    for node in nodes:
        specs = []
        for i, spec in enumerate(node.output_specs):
            if spec is None:
                specs.append(None)
                continue
            shp = node.op.output_shapes[i]
            entries = (list(spec) + [None] * len(shp))[:len(shp)]
            for d, e in enumerate(entries):
                if e is None:
                    continue
                names = e if isinstance(e, tuple) else (e,)
                deg = math.prod(axes.get(a, 1) for a in names)
                if deg <= 1 or shp[d] % deg != 0:
                    entries[d] = None
            specs.append(tuple(entries) if any(entries) else None)
        node.output_specs = specs


@dataclasses.dataclass
class BucketExecutor:
    """One batch bucket's forward path + its search provenance."""

    bucket: int
    executor: Any  # GraphExecutor (comp_mode INFERENCE)
    objective: str  # "latency@batch4" / "reused-training-strategy"
    mesh_axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    predicted_latency_s: Optional[float] = None
    strategy_differs: bool = False  # vs the model's strategy
    # the kernel each op runs in this bucket ({op name -> impl}): "_k:"
    # choices of the bucket's strategy plus each attention op's dispatch,
    # recorded at build time
    kernel_choices: Dict[str, str] = dataclasses.field(default_factory=dict)
    _fwd: Any = None

    def forward(self):
        """The bucket's compiled forward ``fwd(params, state, inputs)``."""
        if self._fwd is None:
            self._fwd = self.executor.make_forward(training=False)
        return self._fwd

    def capture(self, ff) -> None:
        """On the card, capture the forward's graph now, over a zero host
        batch of the model inputs' dtypes (the requests'), whose result is
        dropped; elsewhere nothing."""
        ex = self.executor
        if ex.device.type != "cuda":
            return
        zeros = {n: np.zeros((self.bucket,) + tuple(t.shape[1:]),
                             torch.empty(0, dtype=t.dtype.torch_dtype)
                             .numpy().dtype)
                 for n, t in zip(ex.input_names, ff.input_tensors)}
        ff._refresh_compute_params()
        self.forward()(ff.params, ff.state, zeros)


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
        self.queue = RequestQueue()
        self.scheduler = BatchScheduler(buckets, max_wait_s=max_wait_ms / 1e3)
        self.verbose = verbose
        # False keeps served requests out of the registry latency
        # reservoir (loadgen toggles it off during warmup)
        self.record_latency = True
        self.buckets: Dict[int, BucketExecutor] = {
            b: self._build_bucket(b, budget) for b in buckets}
        for be in self.buckets.values():
            be.capture(ff)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- bucket construction ----------------------------------------------
    @staticmethod
    def _signature(strategy):
        return {g: (s.choice,
                    tuple(tuple(sp) if sp is not None else None
                          for sp in s.output_specs),
                    tuple(sorted((k, tuple(v))
                                 for k, v in s.param_specs.items())))
                for g, s in strategy.items()}

    def _build_bucket(self, bucket: int, budget: int) -> BucketExecutor:
        from flexflow_tpu_torch.executor import GraphExecutor
        from flexflow_tpu_torch.layout import propagate_layouts
        from flexflow_tpu_torch.parallel.strategy import apply_strategy
        from flexflow_tpu_torch.search.unity import (executed_kernel_choices,
                                                     switched_off)

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
        mesh = ff.mesh
        strategy = None
        objective = "reused-training-strategy"
        predicted = None
        if budget and budget > 0:
            try:
                strategy, mesh, objective, predicted, _ = \
                    self._search_bucket(nodes, bucket, budget, ff.mesh.size,
                                        final_ref)
            except Exception as e:
                print(f"[serve] bucket {bucket}: latency search failed "
                      f"({e!r}); reusing the model's strategy",
                      file=sys.stderr)
                strategy, mesh = None, ff.mesh
        if strategy is None:
            # specs are axis names: they apply at any batch the axes
            # still divide (_sanitize_output_specs guards each dim)
            strategy = {g: copy.deepcopy(s) for g, s in ff.strategy.items()}
        differs = self._signature(strategy) != self._signature(ff.strategy)
        full = ff.executor
        kernel_choices = apply_strategy(
            nodes, strategy, mesh,
            kernels=("off" if switched_off(ff.config, "kernel_search",
                                           "FFS_NO_KERNEL_SEARCH")
                     else "chosen"),
            device=full.device)
        if kernel_choices is None:
            kernel_choices = executed_kernel_choices(
                nodes, None, mesh.shape, device=full.device)
        _sanitize_output_specs(nodes, mesh)
        propagate_layouts(nodes, mode=ff.config.conv_compute_layout,
                          on_accelerator=full.device.type == "cuda")
        ex = GraphExecutor(nodes, input_names, final_ref, full.device,
                           compute_dtype=full.compute_dtype, mesh=mesh,
                           fold_conv_bn=full.fold_conv_bn)
        ex.comp_mode = CompMode.INFERENCE
        be = BucketExecutor(
            bucket=bucket, executor=ex, objective=objective,
            mesh_axes=dict(mesh.shape), predicted_latency_s=predicted,
            strategy_differs=differs, kernel_choices=kernel_choices)
        if predicted is not None:
            get_registry().gauge(f"serve/bucket{bucket}/predicted_latency_s",
                                 predicted)
        if self.verbose:
            print(f"[serve] bucket {bucket}: objective={objective} "
                  f"mesh={be.mesh_axes} differs_from_training={differs}",
                  file=sys.stderr)
        return be

    def _search_bucket(self, nodes, bucket: int, budget: int, n_live: int,
                       final_ref):
        """Latency-objective search for one bucket: INFERENCE-mode
        ``graph_optimize`` (forward-only cost model, opt_state_factor 0)
        at this bucket's batch. Rewrites and pipeline meshes are off: the
        bucket executors keep the model's parameter tree and run a plain
        graph."""
        from flexflow_tpu_torch.machine import make_mesh
        from flexflow_tpu_torch.parallel.strategy import filter_specs_to_mesh
        from flexflow_tpu_torch.search import unity

        ff = self.ff
        if ff.machine_spec is None:
            raise RuntimeError("no machine model for this card: compile "
                               "with machine_spec= or --machine-model-file")
        cfg = dataclasses.replace(
            ff.config, computation_mode=CompMode.INFERENCE,
            search_budget=int(budget), enable_parameter_parallel=True,
            enable_pipeline_parallel=False, enable_substitution=False,
            only_data_parallel=False, weight_update_sharding="off",
            overlap_bucket_mb="off")
        cfg.opt_state_factor = 0.0
        mesh_axes, strategy, info = unity.graph_optimize(
            nodes, ff.machine_spec, cfg, n_live, batch=bucket,
            final_ref=final_ref, device=ff.device)
        if math.prod(mesh_axes.values()) == n_live:
            mesh = make_mesh(n_live, mesh_axes)
        else:
            # a factorization over fewer devices than the parameters live
            # on: keep the live mesh, drop the foreign axes from the specs
            mesh = ff.mesh
            filter_specs_to_mesh(strategy, mesh)
        objective = f"{info.get('objective', 'latency')}@batch{bucket}"
        return (strategy, mesh, objective, info.get("predicted_time"),
                info)

    # ---- request path ------------------------------------------------------
    def submit(self, inputs) -> Request:
        """Enqueue one request. ``inputs``: one array per model input,
        WITHOUT the batch dim (a single sample)."""
        return self.queue.submit(
            inputs if isinstance(inputs, (list, tuple)) else [inputs])

    def _stage(self, be: BucketExecutor, arrays: List[np.ndarray]):
        """The padded batch as the bucket's compiled forward takes it:
        host arrays by input name (it copies them to the card), integer
        ids in the input's declared dtype."""
        return {n: host_input(a, t) for n, a, t in
                zip(be.executor.input_names, arrays, self.ff.input_tensors)}

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
            out = host_copy(out)
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
        """Per-bucket provenance: objective, mesh, predicted latency,
        whether the strategy differs from the model's, device and the
        kernel each op runs."""
        return {str(b): dict(objective=be.objective, mesh=be.mesh_axes,
                             predicted_latency_s=be.predicted_latency_s,
                             strategy_differs_from_training=be.strategy_differs,
                             device=str(be.executor.device),
                             kernel_choices=dict(be.kernel_choices))
                for b, be in self.buckets.items()}
