"""Framework-wide enums.

PyTorch counterpart of ``flexflow_tpu/ffconst.py``: the same names and
values, so strategy files and frontends read the same. ``DataType`` maps
to a ``torch.dtype`` where the JAX package maps to a ``jnp`` dtype.
"""

import enum

import torch


class DataType(enum.Enum):
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    FLOAT = "float32"
    DOUBLE = "float64"

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self]

    @property
    def size(self) -> int:
        return self.torch_dtype.itemsize


_TORCH_DTYPES = {
    DataType.BOOL: torch.bool,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.HALF: torch.float16,
    DataType.BFLOAT16: torch.bfloat16,
    DataType.FLOAT: torch.float32,
    DataType.DOUBLE: torch.float64,
}


class ActiMode(enum.Enum):
    AC_MODE_NONE = 0
    AC_MODE_RELU = 1
    AC_MODE_SIGMOID = 2
    AC_MODE_TANH = 3
    AC_MODE_GELU = 4


class AggrMode(enum.Enum):
    AGGR_MODE_NONE = 0
    AGGR_MODE_SUM = 1
    AGGR_MODE_AVG = 2


class PoolType(enum.Enum):
    POOL_MAX = 0
    POOL_AVG = 1


class LossType(enum.Enum):
    CATEGORICAL_CROSSENTROPY = 10
    SPARSE_CATEGORICAL_CROSSENTROPY = 11
    MEAN_SQUARED_ERROR_AVG_REDUCE = 12
    MEAN_SQUARED_ERROR_SUM_REDUCE = 13
    IDENTITY = 14


class MetricsType(enum.Enum):
    ACCURACY = 1001
    CATEGORICAL_CROSSENTROPY = 1002
    SPARSE_CATEGORICAL_CROSSENTROPY = 1003
    MEAN_SQUARED_ERROR = 1004
    ROOT_MEAN_SQUARED_ERROR = 1005
    MEAN_ABSOLUTE_ERROR = 1006


class CompMode(enum.Enum):
    TRAINING = 0
    INFERENCE = 1


class ParameterSyncType(enum.Enum):
    """How gradients are synchronized across data-parallel replicas (the
    names are kept for config parity; one device syncs nothing)."""

    NONE = 0
    PS = 1
    NCCL = 2


class OperatorType(enum.Enum):
    # The full list is kept in the JAX package's order: members are
    # enum.auto(), so their values depend on it.
    # sources
    NOOP = enum.auto()
    INPUT = enum.auto()
    WEIGHT = enum.auto()
    # dense / conv stack
    CONV2D = enum.auto()
    POOL2D = enum.auto()
    BATCHNORM = enum.auto()
    LINEAR = enum.auto()
    EMBEDDING = enum.auto()
    # attention / transformer
    MULTIHEAD_ATTENTION = enum.auto()
    LAYERNORM = enum.auto()
    RMSNORM = enum.auto()
    SOFTMAX = enum.auto()
    # elementwise
    EW_ADD = enum.auto()
    EW_SUB = enum.auto()
    EW_MUL = enum.auto()
    EW_DIV = enum.auto()
    EW_MAX = enum.auto()
    EW_MIN = enum.auto()
    RELU = enum.auto()
    GELU = enum.auto()
    SIGMOID = enum.auto()
    TANH = enum.auto()
    ELU = enum.auto()
    EXP = enum.auto()
    SIN = enum.auto()
    COS = enum.auto()
    POW = enum.auto()
    RSQRT = enum.auto()
    IDENTITY = enum.auto()
    SCALAR_MULTIPLY = enum.auto()
    SCALAR_ADD = enum.auto()
    SCALAR_SUB = enum.auto()
    SCALAR_TRUE_DIV = enum.auto()
    # matmul / shape
    BATCHMATMUL = enum.auto()
    CONCAT = enum.auto()
    SPLIT = enum.auto()
    RESHAPE = enum.auto()
    TRANSPOSE = enum.auto()
    FLAT = enum.auto()
    REVERSE = enum.auto()
    CAST = enum.auto()
    DROPOUT = enum.auto()
    GATHER = enum.auto()
    REDUCE_SUM = enum.auto()
    REDUCE_MAX = enum.auto()
    MEAN = enum.auto()
    TOPK = enum.auto()
    ARG_TOPK = enum.auto()
    CONST = enum.auto()
    WHERE = enum.auto()
    EXPAND = enum.auto()
    EINSUM = enum.auto()
    GROUPNORM = enum.auto()
    LOG = enum.auto()
    # MoE quartet (+ gating sugar)
    GROUP_BY = enum.auto()
    AGGREGATE = enum.auto()
    AGGREGATE_SPEC = enum.auto()
    CACHE = enum.auto()
    EXPERTS = enum.auto()
    # fused compute
    FUSED = enum.auto()
    # parallel (resharding) ops
    REPARTITION = enum.auto()
    COMBINE = enum.auto()
    REPLICATE = enum.auto()
    REDUCTION = enum.auto()
    PIPELINE = enum.auto()
    FUSED_PARALLEL = enum.auto()
    # loss/metrics pseudo-ops
    LOSS = enum.auto()
    METRICS = enum.auto()
    OPTIMIZER = enum.auto()
    ALLREDUCE = enum.auto()
