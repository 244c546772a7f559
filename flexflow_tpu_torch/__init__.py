"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

A second package beside the JAX reference ``flexflow_tpu``, built slice by
slice (ROADMAP.md). This slice serves the BERT-proxy transformer on one
CUDA device: ``FFModel`` builds and compiles it for inference, ``serve()``
answers requests through the continuous-batching ``ServingEngine``, and
each attention op runs a hand-written CUDA flash-attention forward kernel
(``ops/flash_attention.py``, ``csrc/flash_attn_fwd.cu``).

The package imports torch and numpy only: never jax, and nothing of
``flexflow_tpu``. Entry points run on CUDA unless the caller asks for the
CPU (``device="cpu"``).
"""

from flexflow_tpu_torch.ffconst import (ActiMode, CompMode, DataType,
                                        LossType, MetricsType, OperatorType)
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.tensor import Tensor
from flexflow_tpu_torch.model import FFModel, resolve_device
from flexflow_tpu_torch.initializers import (GlorotUniformInitializer,
                                             ZeroInitializer)

__all__ = [
    "ActiMode",
    "CompMode",
    "DataType",
    "FFConfig",
    "FFModel",
    "GlorotUniformInitializer",
    "LossType",
    "MetricsType",
    "OperatorType",
    "Tensor",
    "ZeroInitializer",
    "resolve_device",
]
