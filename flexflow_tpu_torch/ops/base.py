"""Op base class and registry.

PyTorch counterpart of ``flexflow_tpu/ops/base.py``. An Op is (a) a
forward function ``forward(params, inputs, ctx)`` on tensors, (b)
parameter initialization on an explicit ``torch.Generator``, (c) cost
metadata (``flops`` / ``params_elems``) that the search of a later slice
reads, and (d) dimension-role metadata naming the dims that are legal to
shard.
"""

from __future__ import annotations

import enum
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.layer import Layer


class DimRole(enum.Enum):
    """Role of an output dimension — drives the legal sharding axes."""

    SAMPLE = "sample"
    CHANNEL = "channel"
    HEAD = "head"
    SEQ = "seq"
    EXPERT = "expert"
    OTHER = "other"


class OpContext:
    """Per-call context threaded through forward: training flag, compute
    dtype, the ``torch.Generator`` that training-time randomness (Dropout
    and attention-prob dropout) draws from, the mesh the model was
    compiled on (``machine.Mesh`` or None), whose axes decide whether
    attention runs as a ring (the reference's ``ctx.mesh``), the
    device the graph runs on, where an op with no input (a constant)
    puts its output (None: the CPU), and over a process group the mesh's
    collectives (``parallel/comm.py`` ``MeshComm``; None on one
    device), which an op with a sharded rule of its own issues
    (``forward_sharded``)."""

    def __init__(self, training: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 rng: Optional[torch.Generator] = None, mesh=None,
                 device=None, comm=None):
        self.training = training
        self.compute_dtype = compute_dtype
        self.rng = rng
        self.mesh = mesh
        self.device = device
        self.comm = comm

    def next_rng(self) -> torch.Generator:
        """The generator a random draw takes its numbers from. Where the
        reference splits a fresh key for each draw, a torch generator
        advances itself (inside a CUDA-graph capture too: the compiled
        step registers it, so each replay draws anew)."""
        if self.rng is None:
            raise ValueError("op needs rng but none provided")
        return self.rng

    @property
    def mesh_axes(self) -> Dict[str, int]:
        return dict(self.mesh.shape) if self.mesh is not None else {}


class Op:
    op_type: OperatorType = OperatorType.NOOP
    # how the op runs on its rank's shards over a process group when it
    # has no ``forward_sharded`` of its own (parallel/sharded.py):
    # "elementwise", "per_sample" or "whole"
    shard_rule: str = "whole"

    def __init__(self, layer: Layer, input_shapes: Sequence[Tuple[int, ...]]):
        self.layer = layer
        self.name = layer.name
        self.guid = layer.guid
        self.input_shapes: List[Tuple[int, ...]] = [tuple(s) for s in input_shapes]
        self.output_shapes: List[Tuple[int, ...]] = self.compute_output_shapes()
        self.dtype: DataType = layer.data_type

    # ---- graph-construction interface -------------------------------------
    def compute_output_shapes(self) -> List[Tuple[int, ...]]:
        raise NotImplementedError

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Parameter name -> shape, without allocating (the search reads
        it); {} for param-free ops. ``init_params`` gives these shapes."""
        return {}

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Initialize trainable parameters on ``generator.device``; {} for
        param-free ops."""
        return {}

    def forward(self, params: Dict[str, torch.Tensor],
                inputs: List[torch.Tensor], ctx: OpContext) -> List[torch.Tensor]:
        raise NotImplementedError

    # ---- search metadata ---------------------------------------------------
    def output_dim_roles(self) -> List[Tuple[DimRole, ...]]:
        """Per-output tuple of DimRoles; default: dim0=SAMPLE, rest OTHER."""
        return [tuple(DimRole.SAMPLE if i == 0 else DimRole.OTHER
                      for i in range(len(shp)))
                for shp in self.output_shapes]

    def flops(self) -> int:
        """Forward-pass FLOPs (global, unsharded). Backward ≈ 2x."""
        return 2 * sum(math.prod(s) for s in self.output_shapes)

    def params_elems(self) -> int:
        return 0

    def param_key(self) -> Tuple:
        """Structural identity for node dedup / cost caching."""
        return (
            self.op_type,
            tuple(self.input_shapes),
            tuple(sorted(
                (k, repr(v)) for k, v in self.layer.properties.items()
            )),
        )

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class OpRegistry:
    _by_type: Dict[OperatorType, Callable[..., Op]] = {}

    @classmethod
    def create(cls, layer: Layer, input_shapes) -> Op:
        if layer.op_type not in cls._by_type:
            raise NotImplementedError(
                f"no Op registered for {layer.op_type} in the PyTorch port "
                f"(it ports LINEAR, EMBEDDING, LAYERNORM, RMSNORM, "
                f"GROUPNORM, BATCHNORM, DROPOUT, MULTIHEAD_ATTENTION, "
                f"SOFTMAX, CONV2D, POOL2D, FLAT, BATCHMATMUL, the shape, "
                f"reduction and top-k ops, the elementwise kinds and the "
                f"mixture-of-experts ops; "
                f"ROADMAP.md lists the rest)")
        return cls._by_type[layer.op_type](layer, input_shapes)


def register_op(op_type: OperatorType):
    def deco(klass):
        klass.op_type = op_type
        OpRegistry._by_type[op_type] = klass
        return klass

    return deco
