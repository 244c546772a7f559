"""flexflow_tpu_torch/serve — inference serving.

PyTorch counterpart of ``flexflow_tpu/serve``: continuous/dynamic
batching (``batching``) over per-batch-bucket executors (``engine``), and
closed-loop load generation (``loadgen``). KV-cache decode, the
per-bucket latency search and manifest loading come with later slices.
"""

from flexflow_tpu_torch.serve.batching import (BatchScheduler, Request,
                                               RequestQueue, pad_to_bucket,
                                               pick_bucket)
from flexflow_tpu_torch.serve.engine import ServingEngine
from flexflow_tpu_torch.serve.loadgen import (run_closed_loop,
                                              warm_buckets)

__all__ = [
    "BatchScheduler",
    "Request",
    "RequestQueue",
    "ServingEngine",
    "pad_to_bucket",
    "pick_bucket",
    "run_closed_loop",
    "warm_buckets",
]
