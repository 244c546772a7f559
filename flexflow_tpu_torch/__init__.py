"""flexflow_tpu_torch — the PyTorch/CUDA port of flexflow_tpu.

A second package beside the JAX reference ``flexflow_tpu``, built slice by
slice (ROADMAP.md). It serves and trains the BERT-proxy transformer on
one CUDA device, serves and decodes the Llama-family decoder LM
(``models/llama.py``, ``serve/kv_cache.py``), and trains the other five
models of the OSDI'22 protocol (DLRM, XDL, CANDLE-Uno, ResNeXt-50,
Inception-v3) and the reference's ResNet-50 (with BatchNorm) and AlexNet,
the conv family channels-last on the card (``layout.py``): ``FFModel``
builds and
compiles a model, ``fit`` trains it, ``serve()`` answers requests through
the continuous-batching ``ServingEngine``, and the attention ops run
hand-written CUDA flash-attention kernels (``ops/flash_attention.py``,
``csrc/``). Models written elsewhere come in through the frontends:
``flexflow_tpu_torch.torch`` (torch.fx), ``.onnx`` and ``.keras``;
``python -m flexflow_tpu_torch.driver`` launches a script with parsed
``FFConfig`` flags.

The subpackage ``flexflow_tpu_torch.torch`` becomes this package's
attribute ``torch`` once imported, so this module binds no global of
that name and the port's modules import PyTorch absolutely.

The package imports torch and numpy only: never jax, and nothing of
``flexflow_tpu``. Entry points run on CUDA unless the caller asks for the
CPU (``device="cpu"``).
"""

from flexflow_tpu_torch.ffconst import (ActiMode, AggrMode, CompMode,
                                        DataType, LossType, MetricsType,
                                        OperatorType, PoolType)
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.tensor import Tensor
from flexflow_tpu_torch.model import FFModel, resolve_device
from flexflow_tpu_torch.initializers import (ConstantInitializer,
                                             GlorotUniformInitializer,
                                             NormInitializer,
                                             UniformInitializer,
                                             ZeroInitializer)

__all__ = [
    "ActiMode",
    "AggrMode",
    "CompMode",
    "ConstantInitializer",
    "DataType",
    "FFConfig",
    "FFModel",
    "GlorotUniformInitializer",
    "LossType",
    "MetricsType",
    "NormInitializer",
    "OperatorType",
    "PoolType",
    "Tensor",
    "UniformInitializer",
    "ZeroInitializer",
    "resolve_device",
]
