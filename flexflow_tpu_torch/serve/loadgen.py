"""Closed-loop load generation and the serving workload definition.

PyTorch port's counterpart of ``flexflow_tpu/serve/loadgen.py``.
Closed-loop protocol: ``concurrency`` client threads each keep exactly
one request outstanding — submit, wait for the result, submit the next —
so offered load adapts to service rate instead of queueing unboundedly.
Warmup requests are excluded from the reported distribution.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List

import numpy as np

from flexflow_tpu_torch.obs.registry import percentile


def warm_buckets(engine, make_request: Callable[[int], Any],
                 timeout_s: float = 300.0) -> int:
    """Drive EVERY bucket once at full occupancy on the caller's
    thread: each bucket's first-call costs (cuBLAS handles and
    heuristics, allocator growth) are paid here, outside both the
    measured distribution and the registry latency reservoir. Serial
    warmup of N requests would only ever warm the smallest bucket.
    Returns the number of warmup requests served."""
    engine.record_latency = False
    try:
        i = 0
        for b in engine.scheduler.buckets:
            reqs = [engine.submit(make_request(i + j)) for j in range(b)]
            i += b
            engine.pump()
            for r in reqs:
                r.wait(timeout_s)
    finally:
        engine.record_latency = True
    return i


def run_closed_loop(engine, make_request: Callable[[int], Any],
                    num_requests: int, concurrency: int = 4,
                    warmup: int = 0,
                    timeout_s: float = 120.0) -> Dict[str, Any]:
    """Drive ``engine`` (a started ServingEngine) closed-loop.

    ``make_request(i)`` builds request ``i``'s input list (one array
    per model input, no batch dim). ``warmup`` initial requests are
    served serially before measurement starts and excluded from the
    stats — NOTE serial warmup only exercises the smallest bucket;
    callers measuring multi-bucket engines should ``warm_buckets``
    first.
    Returns ``{p50_s, p99_s, mean_s, throughput_rps, num_measured,
    errors, wall_s}``.
    """
    # warmup: outside the measurement and the registry reservoir
    engine.record_latency = False
    try:
        for i in range(warmup):
            engine.submit(make_request(i)).wait(timeout_s)
    finally:
        engine.record_latency = True

    latencies: List[float] = []
    errors: List[str] = []
    lock = threading.Lock()
    counter = [0]

    def client():
        while True:
            with lock:
                if counter[0] >= num_requests:
                    return
                i = counter[0]
                counter[0] += 1
            req = engine.submit(make_request(warmup + i))
            try:
                req.wait(timeout_s)
                with lock:
                    latencies.append(req.latency_s)
            except BaseException as e:
                with lock:
                    errors.append(f"req {req.id}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, daemon=True,
                                name=f"serve-client{c}")
               for c in range(max(1, concurrency))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    s = sorted(latencies)
    out: Dict[str, Any] = dict(
        num_measured=len(s),
        errors=errors,
        wall_s=wall,
        throughput_rps=(len(s) / wall if wall > 0 else 0.0),
    )
    if s:
        out.update(p50_s=percentile(s, 0.50), p99_s=percentile(s, 0.99),
                   mean_s=sum(s) / len(s))
    return out


def serve_workload(name: str = "transformer", on_cpu: bool = True,
                   device=None):
    """One serving workload definition: returns ``(cfg, build, loss,
    make_request)`` where ``build()`` constructs the UNCOMPILED model
    graph on ``device`` and ``make_request(i)`` builds request ``i``'s
    input list (per-sample, no batch dim). ``on_cpu`` picks the small
    configuration; ``device`` picks where it runs (None = the card)."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.ffconst import LossType

    rs = np.random.RandomState(0)
    if name == "transformer":
        from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                           create_transformer)
        cfg = (TransformerConfig(num_layers=2, hidden_size=128, num_heads=4,
                                 seq_length=64, batch_size=8)
               if on_cpu else TransformerConfig())
        samples = rs.randn(64, cfg.seq_length,
                           cfg.hidden_size).astype(np.float32)
        return (cfg,
                lambda: create_transformer(
                    cfg, FFConfig(batch_size=cfg.batch_size), device=device),
                LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                lambda i: [samples[i % len(samples)]])
    if name == "llama":
        from flexflow_tpu_torch.models.llama import (LlamaModelConfig,
                                                     create_llama)
        cfg = (LlamaModelConfig(batch_size=8, seq_length=32,
                                num_hidden_layers=2)
               if on_cpu else
               LlamaModelConfig(batch_size=8, seq_length=512,
                                hidden_size=1024, intermediate_size=4096,
                                num_hidden_layers=8,
                                num_attention_heads=16,
                                num_key_value_heads=4, vocab_size=32000))
        samples = rs.randint(0, cfg.vocab_size,
                             (64, cfg.seq_length)).astype(np.int32)
        return (cfg,
                lambda: create_llama(
                    cfg, FFConfig(batch_size=cfg.batch_size), device=device),
                LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                lambda i: [samples[i % len(samples)]])
    raise ValueError(f"unknown serve workload '{name}' (transformer|llama)")


def build_serve_model(name: str = "transformer", on_cpu: bool = True,
                      device=None):
    """Compiled-for-INFERENCE serving workload model. Returns
    ``(ff, make_request, config_dict)``."""
    import dataclasses as _dc

    from flexflow_tpu_torch.ffconst import CompMode

    cfg, build, loss, make = serve_workload(name, on_cpu, device)
    ff = build()
    ff.compile(None, loss, [], comp_mode=CompMode.INFERENCE)
    return ff, make, _dc.asdict(cfg)
