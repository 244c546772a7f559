"""Counter/gauge registry: cheap process-wide runtime counters.

The PyTorch port's own copy of ``flexflow_tpu/obs/registry.py``: the
serving path (``serve/batching.py``, ``serve/engine.py``) counts requests,
batches and errors here and observes latencies and batch occupancy; a
traced ``fit`` adds its step-time, goodput, MFU and device-trace series
(``obs/devtrace.py``) and exports the snapshot as ``.counters.json``.

``observe()`` keeps a bounded reservoir of samples per series so p50/p99
survive into the snapshot without unbounded memory: at most
``RESERVOIR_SIZE`` floats per series, a uniform sample of the whole stream
(algorithm R with a fixed seed, so snapshots are reproducible for a given
observation sequence).
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Optional

RESERVOIR_SIZE = 512


def percentile(sorted_samples: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted sample list."""
    n = len(sorted_samples)
    rank = max(1, -(-int(q * 100) * n // 100))  # ceil(q*n) via int math
    return sorted_samples[min(rank, n) - 1]


class CounterRegistry:
    """Monotonic counters + last-value gauges + observation summaries
    (count/sum/min/max plus reservoir-sampled p50/p99)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._observations: Dict[str, Dict[str, float]] = {}
        self._samples: Dict[str, List[float]] = {}
        self._rng = random.Random(0xFF5EED)

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        """Streaming count/sum/min/max summary plus a bounded reservoir
        (RESERVOIR_SIZE samples max) for percentile estimates."""
        v = float(value)
        with self._lock:
            o = self._observations.get(name)
            if o is None:
                self._observations[name] = dict(count=1.0, sum=v, min=v,
                                                max=v)
                self._samples[name] = [v]
                return
            o["count"] += 1.0
            o["sum"] += v
            o["min"] = min(o["min"], v)
            o["max"] = max(o["max"], v)
            s = self._samples[name]
            if len(s) < RESERVOIR_SIZE:
                s.append(v)
            else:
                j = self._rng.randrange(int(o["count"]))
                if j < RESERVOIR_SIZE:
                    s[j] = v

    def get(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges.get(name, default)

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            obs: Dict[str, Dict[str, float]] = {}
            for k, v in self._observations.items():
                e = dict(v)
                s = sorted(self._samples.get(k, ()))
                if s:
                    e["p50"] = percentile(s, 0.50)
                    e["p99"] = percentile(s, 0.99)
                obs[k] = e
            return dict(
                counters=dict(self._counters),
                gauges=dict(self._gauges),
                observations=obs,
            )

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._observations.clear()
            self._samples.clear()

    def export(self, path: str, host_id: Optional[int] = None,
               device=None) -> str:
        """Write the snapshot as the ``.counters.json`` artifact."""
        from flexflow_tpu_torch.obs.artifacts import write_artifact
        return write_artifact(path, self.to_dict(), host_id=host_id,
                              kind="counters", device=device)


_REGISTRY = CounterRegistry()


def get_registry() -> CounterRegistry:
    """The process-wide default registry."""
    return _REGISTRY
