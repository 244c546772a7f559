"""ONNX frontend: ModelProto -> the port's FFModel.

PyTorch counterpart of ``flexflow_tpu/onnx``, with its own
dependency-free ModelProto reader and writer (``proto``).
"""

from flexflow_tpu_torch.onnx.model import ONNXModel

__all__ = ["ONNXModel"]
