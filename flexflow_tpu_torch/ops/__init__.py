"""Operator library: ops as functions on tensors + metadata for the search.

PyTorch counterpart of ``flexflow_tpu/ops``: the ops of the BERT-proxy
transformer, the MLP and the Llama-family decoder (embedding, RMSNorm,
the elementwise kinds), the recommendation models' CONCAT, the conv
family's CONV2D, POOL2D, BATCHNORM, GROUPNORM and FLAT, DROPOUT, the
SPLIT the search's linear fusion emits, and the tensor-op surface the
frontends import graphs into (BATCHMATMUL, the shape ops, the reductions
and top-k), and the mixture-of-experts ops (GROUP_BY, AGGREGATE,
AGGREGATE_SPEC, CACHE, EXPERTS), and the parallel ops (REPARTITION,
COMBINE, REPLICATE, REDUCTION, FUSED_PARALLEL).
"""

from flexflow_tpu_torch.ops.base import Op, OpRegistry, register_op
import flexflow_tpu_torch.ops.linear  # noqa: F401
import flexflow_tpu_torch.ops.attention  # noqa: F401
import flexflow_tpu_torch.ops.norm  # noqa: F401
import flexflow_tpu_torch.ops.elementwise  # noqa: F401
import flexflow_tpu_torch.ops.embedding  # noqa: F401
import flexflow_tpu_torch.ops.tensor_ops  # noqa: F401
import flexflow_tpu_torch.ops.conv  # noqa: F401
import flexflow_tpu_torch.ops.matmul  # noqa: F401
import flexflow_tpu_torch.ops.reduce  # noqa: F401
import flexflow_tpu_torch.ops.moe  # noqa: F401
import flexflow_tpu_torch.ops.experts  # noqa: F401
import flexflow_tpu_torch.ops.parallel_ops  # noqa: F401

__all__ = ["Op", "OpRegistry", "register_op"]
