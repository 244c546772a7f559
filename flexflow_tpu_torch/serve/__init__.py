"""flexflow_tpu_torch/serve — inference serving.

PyTorch counterpart of ``flexflow_tpu/serve``: continuous/dynamic
batching (``batching``) over per-batch-bucket executors (``engine``),
KV-cache prefill and incremental decode for causal decoders
(``kv_cache``), closed-loop load generation (``loadgen``), and deploying
a checkpoint manifest (``loader.load_for_serving``).
"""

from flexflow_tpu_torch.serve.batching import (BatchScheduler, Request,
                                               RequestQueue, pad_to_bucket,
                                               pick_bucket)
from flexflow_tpu_torch.serve.engine import ServingEngine
from flexflow_tpu_torch.serve.kv_cache import DecodeSession, init_kv_cache
from flexflow_tpu_torch.serve.loader import load_for_serving
from flexflow_tpu_torch.serve.loadgen import (run_closed_loop,
                                              warm_buckets)

__all__ = [
    "BatchScheduler",
    "DecodeSession",
    "Request",
    "RequestQueue",
    "ServingEngine",
    "init_kv_cache",
    "load_for_serving",
    "pad_to_bucket",
    "pick_bucket",
    "run_closed_loop",
    "warm_buckets",
]
