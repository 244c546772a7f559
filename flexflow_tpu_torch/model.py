"""FFModel: the user-facing model-building API, compile and runtime.

PyTorch counterpart of ``flexflow_tpu/model.py``'s ``FFModel``: the same
deferred layer-building API, a ``compile()`` that materializes operators
from layers and chooses a strategy, and ``fit`` / ``evaluate`` /
``predict`` / ``serve`` over the compiled graph, with the reference's
step-by-step loop (``set_batch``, ``forward``, ``zero_gradients``,
``backward``, ``update``) beside ``fit``. The device is explicit:
``FFModel(config, device=...)`` runs on CUDA unless the caller asks for
the CPU, and raises when no CUDA device is present rather than carry on
on the CPU.

``compile`` takes the reference's branch order: the machine model
(``machine_spec``, ``--machine-model-file``, or ``detect_machine_spec``),
then an imported strategy file, or the Unity search when
``search_budget > 0`` (``search/unity.py``; under ``search_measure_ops``
priced on per-op times taken on the device, ``search/profile.py``),
else the heuristic mesh and
data-parallel strategy; then the export (``--export-strategy``), then
``apply_strategy``, which also turns each op's searched or imported
choice into its kernel: attention ops are pinned to the flash core
(``_k:flash``) or to the einsum core, and ``_k:fused`` ops update through
the fused-Adam kernel; an ``_r`` choice makes the op's forward a
checkpoint in training (remat: the executor's ``remat_ops``), and a
``_k:conv_bn_fused`` choice runs its Conv+BN pair as one node; then the
layout pass (``layout.propagate_layouts``: the conv family channels-last
on the card under ``conv_compute_layout="auto"``); then, under
``lint="warn"|"error"`` (``--lint``), the fflint static verifier
(``analysis/``) over the planned model, before anything is allocated;
then the strategy's Graphviz file where
``export_strategy_computation_graph_file`` (``--compgraph``) names one
(``utils/dot.py``).
Without a process group the port executes on one device, and a compile
prices and lays out one device unless ``workers_per_node`` asks for
more. In a ``torch.distributed`` group (``distributed.initialize``, or
torchrun) a compile lays its mesh over the group's ranks, one a device:
a searched or imported data x model strategy executes, each rank holding
its box of every parameter and feeding the batch rows its position
holds (``executor.py``); rank 0 searches and every rank takes its
strategy. A strategy no slice executes yet (a 'pipe' or 'expert' axis, a
ring beside another axis, ``_wus`` / ``_ovl`` choices, a mesh of another
size than the group) raises after the lint, naming the ROADMAP.md item
that brings it. ``analysis.orchestrator.plan_model`` stops before that
refusal, so such a strategy lints without executing.
"""

from __future__ import annotations

import json
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.executor import (COMPUTE_PARAMS_KEY, GraphExecutor,
                                         OpNode, data_degree)
from flexflow_tpu_torch.ffconst import (ActiMode, AggrMode, CompMode,
                                        DataType, LossType, MetricsType,
                                        OperatorType, PoolType)
from flexflow_tpu_torch.layer import Layer
from flexflow_tpu_torch.layout import propagate_layouts
from flexflow_tpu_torch.machine import (MachineSpec, Mesh,
                                        UnknownDeviceError,
                                        detect_machine_spec, make_mesh,
                                        resolve_device)
from flexflow_tpu_torch.metrics import Metrics, PerfMetrics
from flexflow_tpu_torch.ops import OpRegistry
from flexflow_tpu_torch.ops.attention import MultiHeadAttention
from flexflow_tpu_torch.tensor import Tensor


def devices_to_run(cfg: FFConfig, device: torch.device) -> int:
    """The devices a compile prices and lays its mesh over: the ranks of
    the process group when one is initialized (one rank a device);
    else one, the model's device, unless the caller asks for more with
    ``workers_per_node`` (``num_devices``), capped at the visible cards,
    and a strategy over more than one then raises at compile, after the
    lint, for want of a group."""
    from flexflow_tpu_torch import distributed
    if distributed.process_count() > 1:
        return distributed.process_count()
    if cfg.num_devices <= 0:
        return 1
    avail = torch.cuda.device_count() if device.type == "cuda" else 1
    return min(cfg.num_devices, avail)


class FFModel:
    def __init__(self, config: Optional[FFConfig] = None, device=None):
        self.config = config or FFConfig()
        self.device = resolve_device(device)
        self.layers: List[Layer] = []
        self.input_tensors: List[Tensor] = []
        self.optimizer = None
        self.executor: Optional[GraphExecutor] = None
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.state: Dict[str, Any] = {}
        self.opt_state: Any = None
        self.kernel_choices: Optional[Dict[str, str]] = None
        # names of the ops compile found an "_r" (remat) choice for
        self.remat_ops: Optional[set] = None
        self.mesh: Optional[Mesh] = None
        # the fflint report of the last compile(lint="warn"|"error")
        self.lint_report = None
        # --profiling's per-op table (set by compile)
        self.op_profile = None
        self._iter = 0
        self._last_loss: Optional[float] = None
        # the batch set_batch staged for update: (host inputs, labels)
        self._current_batch = None
        # the iteration's seq_length (forward/backward) and the bucket
        # executors it runs ({bucket length: GraphExecutor})
        self._iter_seq: Optional[int] = None
        self._seq_execs: Dict[int, GraphExecutor] = {}
        # the last step's loss of each epoch fit ran (one host read each)
        self.epoch_losses: List[float] = []
        self._used_names = set()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.config.seed)

    # ======================= tensor/layer construction =====================
    def create_tensor(self, dims: Sequence[int], dtype: DataType = DataType.FLOAT,
                      create_grad: bool = True, name: Optional[str] = None) -> Tensor:
        layer = Layer(OperatorType.INPUT, name or f"input_{len(self.input_tensors)}",
                      [], data_type=dtype)
        # input names key the feed dict — must be unique too
        if layer.name in self._used_names:
            layer.name = f"{layer.name}_{layer.guid}"
        self._used_names.add(layer.name)
        t = Tensor(dims, dtype, owner_layer=layer, name=layer.name)
        layer.outputs = [t]
        self.layers.append(layer)
        self.input_tensors.append(t)
        return t

    def _add_layer(self, op_type: OperatorType, inputs: List[Tensor],
                   props: Dict[str, Any], name: Optional[str] = None,
                   dtype: Optional[DataType] = None) -> Layer:
        layer = Layer(op_type, name, inputs,
                      data_type=dtype or (inputs[0].dtype if inputs else DataType.FLOAT))
        # parameters are keyed by layer name — names must be unique
        if layer.name in self._used_names:
            layer.name = f"{layer.name}_{layer.guid}"
        self._used_names.add(layer.name)
        layer.properties.update(props)
        self.layers.append(layer)
        return layer

    def _finish(self, layer: Layer) -> Tensor:
        op = OpRegistry.create(layer, [t.shape for t in layer.inputs])
        outs = [
            Tensor(s, layer.data_type, owner_layer=layer, owner_idx=i,
                   name=f"{layer.name}_out{i}")
            for i, s in enumerate(op.output_shapes)
        ]
        layer.outputs = outs
        return outs[0] if len(outs) == 1 else tuple(outs)

    def dense(self, input: Tensor, out_dim: int,
              activation: ActiMode = ActiMode.AC_MODE_NONE, use_bias: bool = True,
              datatype: Optional[DataType] = None, kernel_initializer=None,
              bias_initializer=None, name: Optional[str] = None) -> Tensor:
        layer = self._add_layer(OperatorType.LINEAR, [input], dict(
            out_dim=out_dim, activation=activation, use_bias=use_bias,
            kernel_initializer=kernel_initializer, bias_initializer=bias_initializer,
        ), name, datatype)
        return self._finish(layer)

    def conv2d(self, input: Tensor, out_channels: int, kernel_h: int,
               kernel_w: int, stride_h: int, stride_w: int, padding_h: int,
               padding_w: int, activation: ActiMode = ActiMode.AC_MODE_NONE,
               groups: int = 1, use_bias: bool = True,
               kernel_initializer=None, bias_initializer=None,
               name: Optional[str] = None) -> Tensor:
        layer = self._add_layer(OperatorType.CONV2D, [input], dict(
            out_channels=out_channels, kernel_h=kernel_h, kernel_w=kernel_w,
            stride_h=stride_h, stride_w=stride_w, padding_h=padding_h,
            padding_w=padding_w, activation=activation, groups=groups,
            use_bias=use_bias, kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer), name)
        return self._finish(layer)

    def pool2d(self, input: Tensor, kernel_h: int, kernel_w: int,
               stride_h: int, stride_w: int, padding_h: int, padding_w: int,
               pool_type: PoolType = PoolType.POOL_MAX,
               activation: ActiMode = ActiMode.AC_MODE_NONE,
               name: Optional[str] = None) -> Tensor:
        layer = self._add_layer(OperatorType.POOL2D, [input], dict(
            kernel_h=kernel_h, kernel_w=kernel_w, stride_h=stride_h,
            stride_w=stride_w, padding_h=padding_h, padding_w=padding_w,
            pool_type=pool_type, activation=activation), name)
        return self._finish(layer)

    def batch_norm(self, input: Tensor, relu: bool = True,
                   name: Optional[str] = None) -> Tensor:
        layer = self._add_layer(OperatorType.BATCHNORM, [input],
                                dict(relu=relu), name)
        return self._finish(layer)

    def group_norm(self, input: Tensor, groups: int, eps: float = 1e-5,
                   affine: bool = True, name: Optional[str] = None) -> Tensor:
        """Per-group channel normalization (``nn.GroupNorm``)."""
        layer = self._add_layer(OperatorType.GROUPNORM, [input],
                                dict(groups=groups, eps=eps, affine=affine),
                                name)
        return self._finish(layer)

    def dropout(self, input: Tensor, rate: float = 0.5, seed: int = 0,
                name=None) -> Tensor:
        """Dropout at ``rate`` in training; its mask comes from the model's
        generator (``seed`` is kept for the reference's signature)."""
        layer = self._add_layer(OperatorType.DROPOUT, [input],
                                dict(rate=rate, seed=seed), name)
        return self._finish(layer)

    def layer_norm(self, input: Tensor, axes: Sequence[int] = (-1,),
                   elementwise_affine: bool = True, eps: float = 1e-5,
                   name: Optional[str] = None) -> Tensor:
        layer = self._add_layer(OperatorType.LAYERNORM, [input], dict(
            axes=tuple(axes), elementwise_affine=elementwise_affine, eps=eps), name)
        return self._finish(layer)

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor,
                            embed_dim: int, num_heads: int, kdim: int = 0,
                            vdim: int = 0, dropout: float = 0.0, bias: bool = True,
                            qkv_bias: bool = False,
                            add_bias_kv: bool = False, add_zero_attn: bool = False,
                            causal: bool = False, num_kv_heads: int = 0,
                            rope: bool = False, rope_theta: float = 10000.0,
                            kernel_initializer=None,
                            seq_parallel: Optional[str] = None,
                            name: Optional[str] = None) -> Tensor:
        layer = self._add_layer(OperatorType.MULTIHEAD_ATTENTION,
                                [query, key, value], dict(
            embed_dim=embed_dim, num_heads=num_heads, kdim=kdim or embed_dim,
            vdim=vdim or embed_dim, dropout=dropout, bias=bias,
            qkv_bias=qkv_bias, causal=causal,
            num_kv_heads=num_kv_heads or num_heads, rope=rope,
            rope_theta=rope_theta,
            kernel_initializer=kernel_initializer, seq_parallel=seq_parallel), name)
        return self._finish(layer)

    def rms_norm(self, input: Tensor, eps: float = 1e-6,
                 name: Optional[str] = None) -> Tensor:
        """RMSNorm over the last dim (the Llama family)."""
        layer = self._add_layer(OperatorType.RMSNORM, [input],
                                dict(eps=eps), name)
        return self._finish(layer)

    def embedding(self, input: Tensor, num_entries: int, out_dim: int,
                  aggr: AggrMode = AggrMode.AGGR_MODE_NONE,
                  kernel_initializer=None, name: Optional[str] = None) -> Tensor:
        layer = self._add_layer(OperatorType.EMBEDDING, [input], dict(
            num_entries=num_entries, out_dim=out_dim, aggr=aggr,
            kernel_initializer=kernel_initializer), name, DataType.FLOAT)
        return self._finish(layer)

    # ---- elementwise -------------------------------------------------------
    def _unary(self, op_type, x, name=None, scalar=None, inplace=False):
        layer = self._add_layer(op_type, [x], dict(scalar=scalar, inplace=inplace), name)
        return self._finish(layer)

    def _binary(self, op_type, a, b, name=None):
        layer = self._add_layer(op_type, [a, b], {}, name)
        return self._finish(layer)

    def exp(self, x, name=None): return self._unary(OperatorType.EXP, x, name)
    def sin(self, x, name=None): return self._unary(OperatorType.SIN, x, name)
    def cos(self, x, name=None): return self._unary(OperatorType.COS, x, name)
    def relu(self, x, inplace=True, name=None): return self._unary(OperatorType.RELU, x, name, inplace=inplace)
    def gelu(self, x, name=None): return self._unary(OperatorType.GELU, x, name)
    def sigmoid(self, x, name=None): return self._unary(OperatorType.SIGMOID, x, name)
    def tanh(self, x, name=None): return self._unary(OperatorType.TANH, x, name)
    def elu(self, x, inplace=True, name=None): return self._unary(OperatorType.ELU, x, name, inplace=inplace)
    def rsqrt(self, x, name=None): return self._unary(OperatorType.RSQRT, x, name)
    def log(self, x, name=None): return self._unary(OperatorType.LOG, x, name)
    def identity(self, x, name=None): return self._unary(OperatorType.IDENTITY, x, name)
    def pow(self, x, exponent, name=None): return self._unary(OperatorType.POW, x, name, scalar=exponent)
    def scalar_multiply(self, x, scalar, inplace=True, name=None):
        return self._unary(OperatorType.SCALAR_MULTIPLY, x, name, scalar=scalar, inplace=inplace)
    def scalar_add(self, x, scalar, inplace=True, name=None):
        return self._unary(OperatorType.SCALAR_ADD, x, name, scalar=scalar, inplace=inplace)
    def scalar_sub(self, x, scalar, inplace=True, name=None):
        return self._unary(OperatorType.SCALAR_SUB, x, name, scalar=scalar, inplace=inplace)
    def scalar_true_divide(self, x, scalar, inplace=True, name=None):
        return self._unary(OperatorType.SCALAR_TRUE_DIV, x, name, scalar=scalar, inplace=inplace)

    def add(self, a, b, name=None): return self._binary(OperatorType.EW_ADD, a, b, name)
    def subtract(self, a, b, name=None): return self._binary(OperatorType.EW_SUB, a, b, name)
    def multiply(self, a, b, name=None): return self._binary(OperatorType.EW_MUL, a, b, name)
    def divide(self, a, b, name=None): return self._binary(OperatorType.EW_DIV, a, b, name)
    def max(self, a, b, name=None): return self._binary(OperatorType.EW_MAX, a, b, name)
    def min(self, a, b, name=None): return self._binary(OperatorType.EW_MIN, a, b, name)

    def softmax(self, input: Tensor, axis: int = -1, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.SOFTMAX, [input],
                                dict(axis=axis), name)
        return self._finish(layer)

    def concat(self, tensors: Sequence[Tensor], axis: int,
               name=None) -> Tensor:
        layer = self._add_layer(OperatorType.CONCAT, list(tensors),
                                dict(axis=axis), name)
        return self._finish(layer)

    def flat(self, input: Tensor, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.FLAT, [input], {}, name)
        return self._finish(layer)

    def split(self, input: Tensor, sizes, axis: int, name=None):
        if isinstance(sizes, int):
            sizes = [input.shape[axis] // sizes] * sizes
        layer = self._add_layer(OperatorType.SPLIT, [input],
                                dict(sizes=tuple(sizes), axis=axis), name)
        return self._finish(layer)

    def reshape(self, input: Tensor, shape, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.RESHAPE, [input],
                                dict(shape=tuple(shape)), name)
        return self._finish(layer)

    def transpose(self, input: Tensor, perm, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.TRANSPOSE, [input],
                                dict(perm=tuple(perm)), name)
        return self._finish(layer)

    def reverse(self, input: Tensor, axis: int, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.REVERSE, [input],
                                dict(axis=axis), name)
        return self._finish(layer)

    def cast(self, input: Tensor, dtype: DataType, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.CAST, [input], dict(dtype=dtype),
                                name, dtype)
        return self._finish(layer)

    def gather(self, input: Tensor, index: Tensor, axis: int = 0,
               name=None) -> Tensor:
        layer = self._add_layer(OperatorType.GATHER, [input, index],
                                dict(axis=axis), name)
        return self._finish(layer)

    def batch_matmul(self, a: Tensor, b: Tensor, a_seq_length_dim: int = -1,
                     b_seq_length_dim: int = -1, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.BATCHMATMUL, [a, b], dict(
            a_seq_length_dim=a_seq_length_dim,
            b_seq_length_dim=b_seq_length_dim), name)
        return self._finish(layer)

    def reduce_sum(self, input: Tensor, axes, keepdims: bool = False,
                   name=None) -> Tensor:
        layer = self._add_layer(OperatorType.REDUCE_SUM, [input],
                                dict(axes=tuple(axes), keepdims=keepdims),
                                name)
        return self._finish(layer)

    def reduce_max(self, input: Tensor, axes, keepdims: bool = False,
                   name=None) -> Tensor:
        layer = self._add_layer(OperatorType.REDUCE_MAX, [input],
                                dict(axes=tuple(axes), keepdims=keepdims),
                                name)
        return self._finish(layer)

    def constant(self, value, name=None, trainable=False) -> Tensor:
        """Embedded constant tensor (fx get_attr buffers, masks, tables).

        ``trainable=True`` makes it a leaf parameter (``weight``, with
        ``value`` as its initial value) that the optimizer updates: a
        bare learned tensor used directly in forward, e.g. a positional
        embedding."""
        layer = self._add_layer(OperatorType.CONST, [],
                                dict(value=np.asarray(value),
                                     trainable=bool(trainable)), name)
        return self._finish(layer)

    def where(self, cond: Tensor, a: Tensor, b: Tensor, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.WHERE, [cond, a, b], {}, name)
        return self._finish(layer)

    def expand(self, input: Tensor, shape, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.EXPAND, [input],
                                dict(shape=tuple(shape)), name)
        return self._finish(layer)

    def einsum(self, equation: str, tensors: Sequence[Tensor],
               name=None) -> Tensor:
        layer = self._add_layer(OperatorType.EINSUM, list(tensors),
                                dict(equation=equation), name)
        return self._finish(layer)

    def mean(self, input: Tensor, dims, keepdims: bool = False,
             name=None) -> Tensor:
        layer = self._add_layer(OperatorType.MEAN, [input],
                                dict(axes=tuple(dims), keepdims=keepdims),
                                name)
        return self._finish(layer)

    def top_k(self, input: Tensor, k: int, sorted: bool = True, name=None):
        layer = self._add_layer(OperatorType.TOPK, [input],
                                dict(k=k, sorted=sorted), name)
        return self._finish(layer)

    def arg_top_k(self, input: Tensor, k: int, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.ARG_TOPK, [input], dict(k=k),
                                name)
        return self._finish(layer)

    # ---- mixture of experts (ops/moe.py, ops/experts.py) ------------------
    def group_by(self, input: Tensor, assign: Tensor, n: int,
                 alpha: float = 1.0, name=None):
        layer = self._add_layer(OperatorType.GROUP_BY, [input, assign],
                                dict(n=n, alpha=alpha), name)
        return self._finish(layer)

    def aggregate(self, inputs: Sequence[Tensor], n: int,
                  lambda_bal: float = 0.0, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.AGGREGATE, list(inputs),
                                dict(n=n, lambda_bal=lambda_bal), name)
        return self._finish(layer)

    def aggregate_spec(self, inputs: Sequence[Tensor], n: int,
                       lambda_bal: float = 0.0, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.AGGREGATE_SPEC, list(inputs),
                                dict(n=n, lambda_bal=lambda_bal), name)
        return self._finish(layer)

    def cache(self, input: Tensor, num_batches: int = 1, score_fn=None,
              name=None) -> Tensor:
        layer = self._add_layer(OperatorType.CACHE, [input],
                                dict(num_batches=num_batches,
                                     score_fn=score_fn), name)
        return self._finish(layer)

    def experts(self, input: Tensor, gate: Tensor, n: int, k: int,
                hidden_size: int, alpha: float = 2.0,
                lambda_bal: float = 0.0, expert_parallel=None,
                name=None) -> Tensor:
        """Fused MoE experts op: top-k dispatch -> stacked expert FFN ->
        gate-weighted combine (``ops/experts.py``)."""
        layer = self._add_layer(
            OperatorType.EXPERTS, [input, gate],
            dict(n=n, k=k, hidden_size=hidden_size, alpha=alpha,
                 lambda_bal=lambda_bal, expert_parallel=expert_parallel),
            name)
        return self._finish(layer)

    def moe(self, input: Tensor, num_exp: int, num_select: int,
            expert_hidden_size: int, alpha: float = 2.0,
            lambda_bal: float = 0.04, fused: bool = True, name=None) -> Tensor:
        """MoE layer: softmax gate -> top-k -> group_by -> an expert's two
        dense layers -> aggregate. ``fused=True`` runs dispatch, experts
        and combine as the one Experts op (stacked ``[E, ...]`` weights);
        ``fused=False`` builds the reference's literal subgraph (a dense
        pair an expert). The two forms have different parameter trees."""
        gate = self.dense(input, num_exp, name=f"{name or 'moe'}_gate")
        gate = self.softmax(gate)
        if fused:
            return self.experts(input, gate, num_exp, num_select,
                                expert_hidden_size, alpha, lambda_bal,
                                name=f"{name or 'moe'}_experts")
        topk_values, topk_assign = self.top_k(gate, num_select)
        grouped = self.group_by(input, topk_assign, num_exp, alpha,
                                name=f"{name or 'moe'}_group_by")
        if num_exp == 1:
            grouped = (grouped,)
        expert_outs = []
        for e in range(num_exp):
            h = self.dense(grouped[e], expert_hidden_size,
                           activation=ActiMode.AC_MODE_RELU,
                           name=f"{name or 'moe'}_expert{e}_h")
            o = self.dense(h, input.shape[-1],
                           name=f"{name or 'moe'}_expert{e}_o")
            expert_outs.append(o)
        return self.aggregate(
            [topk_values, topk_assign, topk_assign, gate] + expert_outs,
            num_exp, lambda_bal, name=f"{name or 'moe'}_aggregate")

    # ---- parallel (resharding) ops: the explicit PCG API -----------------
    # (ops/parallel_ops.py; over a process group each issues what its
    # output spec demands)
    def repartition(self, input: Tensor, dim: int, degree: int,
                    axis: Optional[str] = None, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.REPARTITION, [input], dict(
            dim=dim, degree=degree,
            axis=axis or ("data" if dim == 0 else "model")), name)
        return self._finish(layer)

    def combine(self, input: Tensor, dim: int, degree: int,
                name=None) -> Tensor:
        layer = self._add_layer(OperatorType.COMBINE, [input],
                                dict(dim=dim, degree=degree), name)
        return self._finish(layer)

    def replicate(self, input: Tensor, degree: int, name=None) -> Tensor:
        layer = self._add_layer(OperatorType.REPLICATE, [input],
                                dict(degree=degree), name)
        return self._finish(layer)

    def reduction(self, input: Tensor, dim: int, degree: int,
                  name=None) -> Tensor:
        layer = self._add_layer(OperatorType.REDUCTION, [input],
                                dict(dim=dim, degree=degree), name)
        return self._finish(layer)

    # ======================= compile ========================================
    def _materialize_nodes(self, input_shape_overrides=None):
        """Layer -> Op materialization. With ``input_shape_overrides``
        ({input layer name -> shape}) every intermediate shape is
        re-derived from the overridden INPUT shapes (the serving engine's
        batch buckets). Returns (nodes, input_names, tensor_ref)."""
        nodes: List[OpNode] = []
        tensor_ref: Dict[int, Tuple] = {}  # Tensor.guid -> ref
        input_names: List[str] = []
        shape_of: Dict[int, Tuple[int, ...]] = {}
        for layer in self.layers:
            if layer.op_type == OperatorType.INPUT:
                t = layer.outputs[0]
                shape_of[t.guid] = tuple(
                    (input_shape_overrides or {}).get(layer.name, t.shape))
                tensor_ref[t.guid] = ("input", layer.name)
                input_names.append(layer.name)
                continue
            op = OpRegistry.create(
                layer, [shape_of.get(t.guid, t.shape) for t in layer.inputs])
            refs = [tensor_ref[t.guid] for t in layer.inputs]
            nodes.append(OpNode(op, refs))
            for i, t in enumerate(layer.outputs):
                tensor_ref[t.guid] = ("op", op.guid, i)
                shape_of[t.guid] = op.output_shapes[i]
        return nodes, input_names, tensor_ref

    def _select_final_ref(self, nodes, tensor_ref):
        """The user-designated tensor, else the sole unconsumed output of
        the final node."""
        out_t = getattr(self, "outputs", None)
        if out_t is not None:
            ref = tensor_ref.get(out_t.guid)
            if ref is None or ref[0] != "op":
                raise ValueError("outputs= must be a tensor produced by a layer")
            return (ref[1], ref[2])
        final_node = nodes[-1]
        consumed = {
            tensor_ref[t.guid][1:]
            for layer in self.layers
            for t in layer.inputs
            if tensor_ref.get(t.guid, ("x",))[0] == "op"
        }
        free = [i for i in range(len(final_node.op.output_shapes))
                if (final_node.guid, i) not in consumed]
        return (final_node.guid, free[0] if len(free) == 1 else 0)

    def _declared_seq(self) -> Optional[int]:
        """The model's sequence extent: the one extent that the compiled
        graph's ops mark with the SEQ role, or None when there is none or
        they disagree (an encoder/decoder pair has no single extent)."""
        from flexflow_tpu_torch.ops.base import DimRole

        found = {shp[d]
                 for node in self.executor.nodes
                 for shp, roles in zip(node.op.output_shapes,
                                       node.op.output_dim_roles())
                 for d, r in enumerate(roles) if r == DimRole.SEQ}
        return found.pop() if len(found) == 1 else None

    def compile(self, optimizer=None,
                loss_type: LossType = LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence[MetricsType] = (),
                comp_mode: CompMode = CompMode.TRAINING,
                machine_spec: Optional[MachineSpec] = None, mesh=None,
                outputs=None, lint: Optional[str] = None) -> None:
        """Materialize ops, choose a strategy (imported, searched, or the
        heuristic data-parallel one), export it when asked, apply it,
        initialize parameters (and the optimizer state for TRAINING), and
        (on CUDA) build the kernels the compiled path runs. ``mesh``
        (``machine.Mesh``) may have one axis above 1, a ring-attention
        sequence axis (``seq``, or an attention's ``seq_parallel``), whose
        ring positions all run on the model's device; a strategy needing
        any other axis above 1 raises.

        ``lint`` runs the fflint static verifier (``analysis/``) on the
        planned model before anything is allocated or refused: "warn"
        records ``self.lint_report``, "error" also raises ValueError on
        any ERROR-severity diagnostic. None defers to ``FFConfig.lint``
        (the ``--lint`` flag)."""
        cfg = self.config
        lint_mode = (lint if lint is not None
                     else getattr(cfg, "lint", "off")) or "off"
        if lint_mode not in ("off", "warn", "error"):
            raise ValueError(
                f"lint expects off|warn|error, got {lint_mode!r}")
        nodes = self._plan(optimizer, loss_type, metrics, comp_mode,
                           machine_spec=machine_spec, mesh=mesh,
                           outputs=outputs)
        # --- fflint static verification (analysis/) ------------------------
        # runs BEFORE parameter allocation, and before the refusal of a
        # mesh this process cannot execute, so an illegal strategy fails
        # fast with its diagnostics
        self.lint_report = None
        if lint_mode != "off":
            from flexflow_tpu_torch.analysis import lint_model
            self.lint_report = lint_model(self)
            if self.lint_report.diagnostics:
                print(self.lint_report.format_human())
            if lint_mode == "error" and self.lint_report.has_errors():
                raise ValueError(
                    f"fflint: {len(self.lint_report.errors)} error-"
                    f"severity diagnostic(s) — see report above "
                    f"(compile with lint='warn' to proceed anyway)")
        if cfg.export_strategy_computation_graph_file:
            from flexflow_tpu_torch.utils.dot import export_strategy_dot
            export_strategy_dot(nodes, self.mesh,
                                cfg.export_strategy_computation_graph_file,
                                include_costs=cfg.include_costs_dot_graph,
                                search_info=self.search_info)
        from flexflow_tpu_torch.parallel.strategy import check_executable
        check_executable(nodes, self.mesh)
        if self.executor.multi_rank:
            self._check_ranks_agree(nodes)

        self.op_profile = None
        if cfg.profiling:
            # --profiling (the original FlexFlow's profiling mode): each op
            # timed on the device, the per-op fwd/bwd table reported
            # through the RecursiveLogger and kept as op_profile
            self.op_profile = self._profile_ops(nodes,
                                                self.executor.compute_dtype)
        self.params, self.state = self.executor.init_params_and_state(
            self._generator)
        self.opt_state = (optimizer.init(self.params)
                          if comp_mode == CompMode.TRAINING else None)
        self._iter = 0
        if self.device.type == "cuda":
            # build the kernels here rather than in the first step or on
            # the serving thread's first batch
            from flexflow_tpu_torch import cuda_build
            names = self._kernels_of_path(nodes, comp_mode)
            cuda_build.build_all(names)
            for name in names:
                cuda_build.load(name)

    def _plan(self, optimizer, loss_type, metrics, comp_mode,
              machine_spec=None, mesh=None, outputs=None,
              num_devices: Optional[int] = None) -> List[OpNode]:
        """Everything of ``compile`` up to the allocation: materialize the
        ops, choose the strategy over ``num_devices`` (default
        ``devices_to_run``), export it when asked, record its specs and
        kernel choices on the nodes, run the layout pass and build the
        executor. Nothing is allocated, and a mesh this process cannot
        execute is not refused here (``compile`` refuses it after the
        lint; ``analysis.orchestrator.plan_model`` stops here). Returns
        the node list the executor runs."""
        cfg = self.config
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a flexflow_tpu_torch.machine.Mesh "
                            f"(machine.make_mesh), got {type(mesh).__name__}")
        if comp_mode == CompMode.TRAINING and optimizer is None:
            raise ValueError("compile(comp_mode=CompMode.TRAINING) needs an "
                             "optimizer")
        cfg.computation_mode = comp_mode
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.metrics = list(metrics)

        nodes, input_names, tensor_ref = self._materialize_nodes()
        if not nodes:
            raise ValueError("model has no layers")
        out_t = outputs if outputs is not None else getattr(self, "outputs", None)
        if isinstance(out_t, (list, tuple)):
            if len(out_t) != 1:
                raise ValueError("exactly one output tensor is supported")
            out_t = out_t[0]
        self.outputs = out_t
        final_ref = self._select_final_ref(nodes, tensor_ref)

        compute_dtype = (torch.bfloat16
                         if cfg.allow_mixed_precision and self.device.type == "cuda"
                         else torch.float32)
        # --- machine + mesh + strategy -----------------------------------
        n_dev = (devices_to_run(cfg, self.device) if num_devices is None
                 else int(num_devices))
        batch0 = self.input_tensors[0].shape[0] if self.input_tensors else 1
        search = (not cfg.import_strategy_file and cfg.search_budget > 0
                  and not cfg.only_data_parallel and mesh is None)
        if machine_spec is None and cfg.machine_model_file:
            machine_spec = MachineSpec.from_file(cfg.machine_model_file)
        elif cfg.machine_model_version > 0 and not cfg.machine_model_file:
            raise ValueError(
                "--machine-model-version > 0 requires --machine-model-file")
        try:
            self.machine_spec = machine_spec or detect_machine_spec(
                n_dev, slices=cfg.slices, device=self.device)
        except UnknownDeviceError:
            if search:
                raise
            self.machine_spec = None  # nothing here prices a strategy
        self.search_info = None
        # "step_time" (TRAINING search), "latency" (INFERENCE search) or
        # None (no search ran): recorded in exported strategy files
        self.search_objective = None
        from flexflow_tpu_torch.parallel.strategy import (
            _record_strategy, data_parallel_strategy, filter_specs_to_mesh,
            tensor_parallel_overrides)
        from flexflow_tpu_torch.search import unity

        self.mesh = mesh
        self.strategy = None
        if cfg.import_strategy_file:
            mesh_axes, self.strategy = unity.import_strategy_file(
                cfg.import_strategy_file, nodes)
            if self.mesh is None:
                self.mesh = make_mesh(math.prod(mesh_axes.values()), mesh_axes)
            filter_specs_to_mesh(self.strategy, self.mesh)
        elif search:
            # optimizer-state copies the simulator prices: 0 plain SGD,
            # 1 momentum, 2 the Adam family
            from flexflow_tpu_torch.optimizers import SGDOptimizer
            if comp_mode == CompMode.INFERENCE:
                cfg.opt_state_factor = 0.0
            elif isinstance(optimizer, SGDOptimizer):
                cfg.opt_state_factor = 1.0 if optimizer.momentum else 0.0
            else:
                cfg.opt_state_factor = 2.0
            measured = None
            if cfg.search_measure_ops:
                # price the search on per-op times taken on the model's
                # device, in its compute dtype and execution layout (the
                # original FlexFlow's measure_operator_cost pass)
                from flexflow_tpu_torch.search.profile import microbenchmark
                propagate_layouts(nodes, mode=cfg.conv_compute_layout,
                                  on_accelerator=self.device.type == "cuda")
                measured = microbenchmark(
                    nodes, machine_spec=self.machine_spec,
                    device=self.device, dtype=compute_dtype,
                    cache_file=cfg.measured_cache_file)
            mesh_axes, self.strategy, self.search_info = self._search(
                nodes, cfg, n_dev, measured, batch0, final_ref)
            self.search_objective = self.search_info.get("objective")
            self.mesh = make_mesh(math.prod(mesh_axes.values()), mesh_axes)
            # the substitution engine may have rewritten the graph: run
            # the rewritten node list (the strategy is keyed to it)
            if self.search_info.get("rewritten_nodes") is not None:
                nodes = self.search_info["rewritten_nodes"]
                if self.search_info.get("final_ref") is not None:
                    final_ref = tuple(self.search_info["final_ref"])
        if self.mesh is None:
            self.mesh = self._heuristic_mesh(n_dev, batch0)
        if self.strategy is None:
            self.strategy = data_parallel_strategy(nodes, self.mesh)
            if cfg.enable_parameter_parallel:
                self.strategy = tensor_parallel_overrides(
                    nodes, self.mesh, self.strategy)
        if cfg.export_strategy_file:
            unity.export_strategy_file(cfg.export_strategy_file,
                                       dict(self.mesh.shape), self.strategy,
                                       nodes, objective=self.search_objective)
        # the kernel dimension ran when a search ran or a choice names a
        # kernel; pipe meshes never enumerate it
        kernel_on = ((self.search_info is not None
                      or any("_k:" in (st.choice or "")
                             for st in self.strategy.values()))
                     and not unity.switched_off(cfg, "kernel_search",
                                                "FFS_NO_KERNEL_SEARCH")
                     and self.mesh.shape.get("pipe", 1) == 1)
        # the specs and kernel choices are recorded on any mesh here;
        # compile refuses a mesh it cannot execute after the lint
        self._kernel_mode = "all" if kernel_on else "off"
        self.kernel_choices = _record_strategy(
            nodes, self.strategy, self.mesh, kernels=self._kernel_mode,
            training=comp_mode == CompMode.TRAINING, device=self.device)
        # remat: the ops whose "_r" choice won run under a checkpoint in
        # training; the off switch (--remat-search off / FFS_NO_REMAT) runs
        # every op plainly, bit-identical to a strategy without "_r". Pipe
        # meshes carry block-level remat instead (ROADMAP.md Queue 1 item
        # 10), as in the reference.
        self.remat_ops = None
        if (not unity.switched_off(cfg, "remat_search", "FFS_NO_REMAT")
                and self.mesh.shape.get("pipe", 1) == 1):
            self.remat_ops = unity.executed_remat_ops(nodes,
                                                      self.strategy) or None
        # the conv family's execution layout: channels-last on the card
        # under "auto" (layout.py), NCHW the API boundary either way
        # over a process group the activations keep NCHW, the layout
        # their specs name
        from flexflow_tpu_torch.parallel.strategy import runs_over_group
        self.layout_info = propagate_layouts(
            nodes, mode=("nchw" if runs_over_group(nodes, self.mesh)
                         else cfg.conv_compute_layout),
            on_accelerator=self.device.type == "cuda")
        final_op = next(n.op for n in nodes if n.guid == final_ref[0])
        final_is_softmax = final_op.op_type == OperatorType.SOFTMAX
        self._final_is_softmax = final_is_softmax

        wus, wus_ops, overlap, bucket_mb = self._weight_update_sharding(
            nodes, comp_mode)
        self.executor = GraphExecutor(
            nodes, input_names, final_ref, self.device,
            compute_dtype=compute_dtype, loss_type=loss_type,
            metrics=Metrics(loss_type, list(metrics),
                            preds_are_probs=final_is_softmax),
            optimizer=optimizer, final_is_softmax=final_is_softmax,
            kernel_choices=self.kernel_choices, mesh=self.mesh,
            remat_ops=self.remat_ops, fold_conv_bn=cfg.fold_conv_bn,
            weight_update_sharding=wus, wus_ops=wus_ops,
            overlap_grad_sync=overlap,
            # MB (1e6), the native bucket sweep's wire-byte unit
            overlap_bucket_bytes=int(bucket_mb * 1e6))
        self.executor.comp_mode = comp_mode
        self._seq_execs = {}
        return nodes

    def _check_ranks_agree(self, nodes) -> None:
        """Raise unless every rank of the group holds this strategy (its
        file body's digest) and resolved weight-update sharding, the
        overlap and its bucket size alike, before any collective of the
        model runs."""
        import hashlib

        from flexflow_tpu_torch import distributed
        from flexflow_tpu_torch.search import unity
        ex = self.executor
        body = json.dumps(dict(
            strategy=unity.strategy_json(dict(self.mesh.shape),
                                         self.strategy, nodes),
            wus=ex.weight_update_sharding,
            wus_ops=sorted(ex.wus_ops) if ex.wus_ops is not None else None,
            overlap=ex.grad_overlap, bucket=ex.overlap_bucket_bytes),
            sort_keys=True, default=str)
        vals, same = distributed.ranks_agree(
            int(hashlib.sha256(body.encode()).hexdigest()[:12], 16))
        if not same:
            raise RuntimeError(f"the ranks of the process group hold "
                               f"different strategies (digests {vals})")

    def _search(self, nodes, cfg, n_dev, measured, batch0, final_ref):
        """The Unity search -> (mesh axes, strategy, search info). In a
        process group rank 0 searches and broadcasts the strategy as its
        file body; every rank takes it and the ranks check that they hold
        the same one before any collective of the model runs."""
        from flexflow_tpu_torch import distributed
        from flexflow_tpu_torch.search import unity

        multi = distributed.process_count() > 1
        result = error = None
        if not multi or distributed.process_index() == 0:
            try:
                result = unity.graph_optimize(
                    nodes, self.machine_spec, cfg, n_dev, measured=measured,
                    batch=batch0, final_ref=final_ref, device=self.device)
            except (RuntimeError, OSError) as e:
                error = e
            if (result is not None and multi
                    and result[2].get("rewritten_nodes") is not None):
                error = RuntimeError(
                    "the search rewrote the graph, and a rewritten graph "
                    "is not carried to the other ranks of a process group "
                    "(ROADMAP.md Queue 1 item 3.6); pass --disable-substitution")
        if multi:
            payload = None
            if distributed.process_index() == 0:
                payload = (dict(error=str(error)) if error is not None else
                           dict(body=unity.strategy_json(
                               result[0], result[1], nodes,
                               objective=result[2].get("objective")),
                               info={k: v for k, v in result[2].items()
                                     if k not in ("rewritten_nodes",
                                                  "final_ref")}))
            payload = distributed.broadcast_object(payload)
            if "error" in payload:
                error = error or RuntimeError(payload["error"])
            else:
                mesh_axes, strategy = unity.strategy_from_json(
                    payload["body"], nodes)
                result = (mesh_axes, strategy, payload["info"])
        if error is not None:
            # a requested search never degrades to data parallelism
            raise RuntimeError(
                f"auto-parallelization search was requested "
                f"(search_budget={cfg.search_budget}) but failed: {error}. "
                f"Drop --budget to run data-parallel.") from error
        return result

    def _weight_update_sharding(self, nodes, comp_mode):
        """(wus, wus_ops, overlap, bucket_mb): the JAX package's decision
        of weight-update sharding and the comms-compute overlap for this
        strategy (``flexflow_tpu/model.py`` compile). 'off' and inference
        keep WUS off, 'on' turns it on at a data degree above 1, 'auto'
        follows the search's '_wus' choices when it ran (``wus_ops``: the
        ops that chose it) and engages at a data degree of 4 or more
        otherwise. The overlap: 'auto' follows the searched '_ovl'
        choices and bucket size, or WUS on a strategy not searched, at 4
        MB; N forces N-MB buckets; 'off' or '0' disables it. The
        executor turns WUS off on a data degree of 1."""
        from flexflow_tpu_torch.search.unity import (overlap_choice_of,
                                                     wus_choice_of)
        cfg = self.config
        data_deg = data_degree(self.mesh)
        wus_mode = getattr(cfg, "weight_update_sharding", "auto")
        if wus_mode not in ("auto", "on", "off"):
            raise ValueError(f"weight_update_sharding expects auto|on|off, "
                             f"got {wus_mode!r}")
        searched = isinstance(self.search_info, dict)
        choice_of = {n.op.guid: getattr((self.strategy or {}).get(n.op.guid),
                                        "choice", None) for n in nodes}
        searched_wus = searched and any(
            wus_choice_of(getattr(st, "choice", None))
            for st in (self.strategy or {}).values())
        if comp_mode == CompMode.INFERENCE or wus_mode == "off":
            wus = False
        elif wus_mode == "on":
            wus = data_deg > 1
        else:
            wus = searched_wus if searched else data_deg >= 4
        wus_ops = None
        if wus and wus_mode == "auto" and searched and searched_wus:
            wus_ops = {n.op.name for n in nodes
                       if wus_choice_of(choice_of[n.op.guid])}
        ovl_raw = str(getattr(cfg, "overlap_bucket_mb", "auto")).lower()
        searched_ovl = searched and any(
            overlap_choice_of(getattr(st, "choice", None))
            for st in (self.strategy or {}).values())
        searched_bucket = ((self.search_info or {}).get("overlap") or {}).get(
            "bucket_mb") if searched else None
        if ovl_raw in ("0", "off"):
            overlap, bucket_mb = False, 4.0
        elif ovl_raw == "auto":
            overlap = searched_ovl if searched else wus
            bucket_mb = float(searched_bucket or 4.0)
        else:
            bucket_mb = float(int(ovl_raw))
            overlap = bucket_mb > 0
        return wus, wus_ops, overlap, bucket_mb

    def _profile_ops(self, nodes, compute_dtype) -> Dict[str, float]:
        from flexflow_tpu_torch.search.profile import (executed_impl,
                                                       executed_rows,
                                                       microbenchmark)
        from flexflow_tpu_torch.utils.logger import RecursiveLogger
        plog = RecursiveLogger("profiling")
        with plog.enter(f"per-op device microbenchmarks ({len(nodes)} ops)"):
            prof = microbenchmark(nodes, machine_spec=self.machine_spec,
                                  device=self.device, dtype=compute_dtype,
                                  cache_file=self.config.measured_cache_file)
            for node in nodes:
                # the core that runs the op: attention's flash rows where
                # the kernel takes it, else the plain rows
                impl = executed_impl(self, node.op)
                f_s, b_s = executed_rows(prof, node.guid, impl)
                if f_s is not None:
                    core = f"  [{impl}]" if impl else ""
                    plog.info(f"{node.op.name}: fwd {f_s * 1e6:9.1f}us  "
                              f"bwd {b_s * 1e6:9.1f}us{core}")
        return prof

    def _heuristic_mesh(self, n_dev: int, batch0: int) -> Mesh:
        """The mesh without a search: data parallel over the devices the
        batch divides (with a 2-way 'model' axis under
        ``enable_parameter_parallel``)."""
        cfg = self.config
        mp = (2 if cfg.enable_parameter_parallel and not cfg.only_data_parallel
              and n_dev % 2 == 0 and n_dev > 1 else 1)
        dp = n_dev // mp
        while dp > 1 and batch0 % dp != 0:
            dp //= 2
        axes = {"data": dp}
        if mp > 1:
            axes["model"] = mp
        return make_mesh(dp * mp, axes)

    def _selected_impl(self, op: MultiHeadAttention, comp_mode) -> str:
        """``op.selected_impl`` for this model's device, mesh and mode."""
        return op.selected_impl(
            self.device, self.mesh.shape if self.mesh is not None else None,
            training=comp_mode == CompMode.TRAINING)

    def _kernels_of_path(self, nodes, comp_mode) -> List[str]:
        """The CUDA kernel sources the compiled path launches: the flash
        sources for a flash or ring attention (the ring's inner block is
        K5, in the same sources), the backward's only in training."""
        flash = any(isinstance(n.op, MultiHeadAttention)
                    and self._selected_impl(n.op, comp_mode)
                    in ("flash", "ring")
                    for n in nodes)
        names = ["flash_attn_fwd"] if flash else []
        if comp_mode == CompMode.TRAINING:
            from flexflow_tpu_torch.optimizers import AdamOptimizer
            if flash:
                names.append("flash_attn_bwd")
            if isinstance(self.optimizer, AdamOptimizer) and any(
                    n in self.params for n in self.executor.fused_update_ops):
                names.append("fused_adam")
        return names

    # ======================= data staging ==================================
    def _host_inputs(self, xs) -> Dict[str, np.ndarray]:
        """One host array per model input -> {input name: array}, the
        batch the compiled steps take (they copy it to the card and cast
        it there)."""
        if not isinstance(xs, (list, tuple)):
            xs = [xs]
        names = self.executor.input_names
        if len(xs) != len(names):
            raise ValueError(f"model has {len(names)} inputs, got {len(xs)} arrays")
        return {n: host_input(x, t)
                for n, x, t in zip(names, xs, self.input_tensors)}

    def _stage_inputs(self, xs) -> Dict[str, torch.Tensor]:
        """Host arrays -> device tensors, the batch the eager steps take;
        float inputs in the compute dtype (activations flow in it end to
        end)."""
        return {n: stage_array(x, self.device, self.executor.compute_dtype)
                for n, x in self._host_inputs(xs).items()}

    def _stage_labels(self, y) -> torch.Tensor:
        """Labels on the device, float labels in f32 (the loss is f32)."""
        return stage_array(y, self.device, torch.float32)

    # ======================= train / eval loops ============================
    def _make_tracer(self, trace_dir, run_name: str):
        """Tracer for one fit/evaluate call: the explicit ``trace_dir``
        wins over ``--trace-dir``; both unset returns the shared no-op
        (``obs/``: the untraced path pays nothing)."""
        from flexflow_tpu_torch.obs import make_tracer, model_context
        tracer = make_tracer(trace_dir or self.config.trace_dir,
                             run_name=run_name, device=self.device)
        if tracer.active:
            tracer.set_meta(**model_context(self))
        return tracer

    def _train_captures(self) -> int:
        """Captures the compiled train step has made (the card's)."""
        graph = self.executor.step_graphs.get("train_step")
        return graph.captures if graph is not None else 0

    def _make_capture(self, tracer, profile_steps):
        """Windowed torch.profiler device-trace capture (``obs/devtrace``):
        the explicit ``profile_steps`` wins over ``--profile-steps``; both
        unset (or no active tracer) returns the shared no-op capture. On
        the card a window step that captures the train step's CUDA graph
        is named and left out of the attribution."""
        from flexflow_tpu_torch.obs import make_capture
        return make_capture(
            tracer, profile_steps or self.config.profile_steps,
            capture_count=(self._train_captures
                           if self.device.type == "cuda" else None))

    def _finalize_trace(self, tracer, success: bool = True,
                        devtrace=None) -> None:
        """Export the trace, the step summary (FLOPs, memory, collective
        census), the simulated schedule and the drift report, in the
        reference's order: the device trace first (its lanes land in the
        exported trace and its per-collective times join the drift
        report), then the step metrics, the simulated schedule, the
        export, the search trace, the summary, the drift report and the
        counters. A failure warns instead of killing the run that
        produced the data; ``success=False`` (the run raised) flushes the
        trace and counters only."""
        if not tracer.active:
            return
        import os
        import sys
        from flexflow_tpu_torch.obs import (drift_report, export_step_summary,
                                            get_registry, record_step_metrics,
                                            write_artifact, write_simtrace)
        devrep = None
        if devtrace is not None and devtrace.active:
            try:
                devrep = devtrace.finalize(self, tracer)
            except Exception as e:
                print(f"[obs] device-trace attribution failed: {e!r}",
                      file=sys.stderr)
        step_metrics = None
        try:
            step_metrics = record_step_metrics(self, tracer)
        except Exception as e:
            print(f"[obs] step metrics failed: {e!r}", file=sys.stderr)
        if success:
            try:
                write_simtrace(self, tracer)
            except Exception as e:
                print(f"[obs] simulated-schedule trace failed: {e!r}",
                      file=sys.stderr)
        try:
            tracer.export()
        except Exception as e:
            print(f"[obs] trace export failed: {e!r}", file=sys.stderr)
        stem = os.path.join(tracer.trace_dir, tracer.file_stem)
        extra = dict(run_name=tracer.run_name, run_seq=tracer.run_seq)
        if (isinstance(self.search_info, dict)
                and self.search_info.get("search_trace")):
            try:
                write_artifact(stem + ".searchtrace.json",
                               dict(self.search_info["search_trace"]),
                               host_id=tracer.host_id, kind="searchtrace",
                               header_extra=extra, device=self.device)
            except Exception as e:
                print(f"[obs] search-trace artifact failed: {e!r}",
                      file=sys.stderr)
        if success:
            summary = None
            try:
                summary = export_step_summary(self, tracer)
            except Exception as e:
                print(f"[obs] step inspection failed: {e!r}",
                      file=sys.stderr)
            try:
                rep = drift_report(
                    self, tracer.step_time_s(),
                    census=(summary or {}).get("collectives"),
                    phase_summary=tracer.phase_summary(),
                    measured_collectives=(devrep or {}).get("collectives"),
                    step_metrics=step_metrics)
                write_artifact(stem + ".drift.json", rep,
                               host_id=tracer.host_id, kind="drift",
                               header_extra=extra, device=self.device)
            except Exception as e:
                print(f"[obs] drift report failed: {e!r}", file=sys.stderr)
        else:
            print(f"[obs] run failed: wrote trace/counters only "
                  f"({tracer.file_stem})", file=sys.stderr)
        try:
            get_registry().export(stem + ".counters.json",
                                  host_id=tracer.host_id, device=self.device)
        except Exception as e:
            print(f"[obs] counter export failed: {e!r}", file=sys.stderr)

    def _make_health(self, tracer=None, devtrace=None,
                     run_name: str = "fit"):
        """RuntimeHealth for one fit call (None when supervision is off).
        ``--grace-window`` turns SIGTERM/SIGINT into a graceful stop the
        step loop honors (final checkpoint + ``PREEMPTED_EXIT``);
        ``--watchdog-timeout`` starts the hung-step watchdog, whose trip
        flushes this run's trace from the watchdog thread first."""
        cfg = self.config
        if cfg.grace_window_s <= 0 and cfg.watchdog_timeout_s <= 0:
            return None
        from flexflow_tpu_torch.runtime_health import RuntimeHealth

        def _flush_trace():
            self._finalize_trace(tracer, success=False, devtrace=devtrace)

        return RuntimeHealth(
            grace_window_s=cfg.grace_window_s,
            watchdog_timeout_s=cfg.watchdog_timeout_s, run_name=run_name,
            finalize_fn=(_flush_trace if tracer is not None
                         and tracer.active else None))

    def _make_checkpointer(self, checkpoint_dir, checkpoint_every, resume,
                           run_name: str = "fit", heartbeat=None,
                           state_provider=None):
        """(CheckpointManager, start step) for one fit call ((None, 0) when
        checkpointing is off). Explicit arguments win over the
        ``--checkpoint-*`` / ``--resume`` config flags. With resume on,
        the newest COMPLETE checkpoint restores (a directory holding only
        partial ones raises) and the returned start step tells the epoch
        loop how many step slots to skip; an empty directory is a fresh
        launch, so one command line serves the first start and every
        restart. ``state_provider()`` gives the JSON-able client state
        each manifest records (``fit_loader``'s loader cursor). Over a
        process group every rank makes its own manager on the one
        directory: each saves its boxes (its WUS shards of the master
        and moments), and the restore writes each rank's boxes into its
        shard buffers and gathers the working copy anew; the ranks agree
        on a fresh start or a load before either."""
        cfg = self.config
        cdir = checkpoint_dir or cfg.checkpoint_dir
        do_resume = resume if resume is not None else cfg.resume
        every = (checkpoint_every if checkpoint_every is not None
                 else cfg.checkpoint_every)
        if not cdir:
            if do_resume:
                raise ValueError(
                    "resume requested but no checkpoint directory — pass "
                    "fit(checkpoint_dir=...) or --checkpoint-dir")
            if every:
                # a cadence with nowhere to write would train for hours
                # saving nothing
                raise ValueError(
                    f"checkpoint_every={every} requested but no checkpoint "
                    f"directory — pass fit(checkpoint_dir=...) or "
                    f"--checkpoint-dir")
            return None, 0
        from flexflow_tpu_torch.ckpt import CheckpointManager
        mgr = CheckpointManager(self, cdir, every=every,
                                retain=cfg.checkpoint_retain,
                                async_write=cfg.checkpoint_async,
                                run_name=run_name, heartbeat=heartbeat,
                                state_provider=state_provider)
        start = mgr.resume() if do_resume else 0
        return mgr, start

    def _run_epochs(self, next_batch, num_batches: int, bs: int,
                    epochs: int, verbose: bool, ckpt_mgr=None,
                    start_step: int = 0, health=None, tracer=None,
                    devtrace=None, on_epoch_start=None,
                    on_resume=None) -> float:
        """Epoch loop: one compiled train step per batch (a CUDA-graph
        replay on the card), metric sums added up on the device and read
        once per epoch, the ELAPSED TIME / THROUGHPUT report.
        ``next_batch(epoch, b)`` -> (inputs dict, labels).

        ``ckpt_mgr`` (a ``ckpt.CheckpointManager``) saves every
        ``checkpoint_every`` iterations (blocking only for the snapshot's
        device→host copy; the files and the manifest commit run on its
        writer thread) and once more at the end. A resumed run passes
        ``start_step``: the first ``start_step`` step slots of the epoch
        grid are skipped at no cost, the slots the checkpoint covers, so
        epochs and batch indices line up with the uninterrupted schedule.
        ``on_epoch_start()`` runs before each epoch, and a resumed run
        calls ``on_resume(start_step)`` once, right before its first step:
        ``fit_loader`` resets its loaders there and seeks them to the
        first batch the checkpoint does not cover, fetching none of the
        covered ones. After each step ``faults.step_hook`` runs
        (``FFS_FAULT``), and ``health`` (``runtime_health.RuntimeHealth``)
        takes the watchdog heartbeat and the preemption check: a pending SIGTERM raises
        ``Preempted`` after the in-flight step, and this loop cuts the
        grace-window checkpoint before it propagates. Steps that neither
        save nor stop read nothing from the card.

        With an active ``tracer`` (``obs/tracer.py``) each step is a span
        with dispatch and device_wait phases (device_wait fences the step
        on the card: an observer effect tracing accepts, so that a step's
        span holds its device time) beside the phases ``next_batch``
        records, checkpoints are checkpoint / grace_checkpoint spans, and
        each epoch's read is a metrics_sync span; on the card each
        replayed step's peak memory is read
        (``torch.cuda.max_memory_allocated`` after
        ``reset_peak_memory_stats``) into ``_step_peak_bytes``, the
        largest of this run's steps (a traced run starts it afresh).
        ``devtrace`` (``obs/devtrace.py``) wraps each step of its window
        in the profiler session, outside the step span. Without either,
        no step fences and none reads memory statistics.

        Registry (``obs/registry.py``): ``train/step_latency_s`` observes
        each step's host time since the previous step ended. Steps are
        asynchronous on the card except the last of each epoch, which
        includes the epoch's one read of the loss and metrics; with one
        batch per epoch every observation is a whole step. The counters
        ``flash_bwd.launches`` and ``fused_adam.launches`` grow by the
        kernel launches of the run."""
        from flexflow_tpu_torch.ckpt import faults
        from flexflow_tpu_torch.obs import NULL_CAPTURE, NULL_TRACER
        from flexflow_tpu_torch.obs.registry import get_registry
        from flexflow_tpu_torch.ops.flash_attention import flash_bwd
        from flexflow_tpu_torch.ops.fused_update import fused_adam_multi

        tracer = tracer or NULL_TRACER
        devtrace = devtrace or NULL_CAPTURE
        traced = tracer.active or devtrace.active
        read_peak = traced and self.device.type == "cuda"
        if traced:
            self._step_peak_bytes = None
        reg = get_registry()
        train_step = self.executor.make_train_step()
        self._refresh_compute_params()
        launched = (flash_bwd.launches, fused_adam_multi.launches)
        start = time.time()
        executed = 0
        step_idx = -1  # the global step slot, the --profile-steps index
        for epoch in range(epochs):
            if on_epoch_start is not None:
                on_epoch_start()
            self._metrics_acc = PerfMetrics()
            mtotals = None
            loss = None
            epoch_executed = 0
            t_prev = time.perf_counter()
            for b in range(num_batches):
                step_idx += 1
                if step_idx < start_step:
                    continue  # inside the restored checkpoint
                if step_idx == start_step and start_step and on_resume:
                    # after this epoch's on_epoch_start, before the first
                    # fetch of the resumed run
                    on_resume(start_step)
                # devtrace outside tracer.step: the profiler's start and
                # stop at the window's edges are not step time
                with devtrace.step(step_idx), tracer.step():
                    if read_peak:
                        captures = self._train_captures()
                        torch.cuda.reset_peak_memory_stats(self.device)
                    inputs, labels = next_batch(epoch, b)
                    with tracer.phase("dispatch"):
                        (self.params, self.opt_state, self.state, loss,
                         mvals) = train_step(self.params, self.opt_state,
                                             self.state, inputs, labels,
                                             self._generator)
                    self._iter += 1
                    # the step's metric sums are overwritten by its next
                    # call
                    mtotals = ({k: v.clone() for k, v in mvals.items()}
                               if mtotals is None else
                               {k: mtotals[k] + v for k, v in mvals.items()})
                    if traced:
                        with tracer.phase("device_wait"):
                            if self.device.type == "cuda":
                                torch.cuda.synchronize(self.device)
                        if read_peak and self._train_captures() == captures:
                            self._step_peak_bytes = max(
                                self._step_peak_bytes or 0.0,
                                float(torch.cuda.max_memory_allocated(
                                    self.device)))
                executed += 1
                epoch_executed += 1
                faults.step_hook(step_idx)
                if health is not None:
                    try:
                        health.step_done(step_idx)
                    except BaseException:
                        if ckpt_mgr is not None:
                            t_grace = time.perf_counter()
                            with tracer.phase("grace_checkpoint"):
                                ckpt_mgr.finalize(
                                    elapsed_s=time.time() - start,
                                    steps=executed)
                            reg.gauge(
                                f"{ckpt_mgr.run_name}/grace_checkpoint_s",
                                time.perf_counter() - t_grace)
                        raise
                if ckpt_mgr is not None:
                    if ckpt_mgr.should_save(self._iter):
                        with tracer.phase("checkpoint"):
                            ckpt_mgr.save(self._iter)
                    else:
                        ckpt_mgr.note_step(self._iter)
                if b + 1 < num_batches:
                    now = time.perf_counter()
                    reg.observe("train/step_latency_s", now - t_prev)
                    t_prev = now
            if not epoch_executed:
                continue  # the whole epoch is inside the checkpoint
            # the epoch's one host read; a resumed run's partial epoch
            # averages over the steps it ran
            with tracer.phase("metrics_sync", epoch=epoch):
                self._metrics_acc.update(mtotals or {}, bs * epoch_executed)
                self._last_loss = float(loss)
            self.epoch_losses.append(self._last_loss)
            reg.observe("train/step_latency_s", time.perf_counter() - t_prev)
            if verbose:
                rep = self._metrics_acc.report()
                print(f"epoch {epoch}: loss={self._last_loss:.4f} " +
                      " ".join(f"{k}={v:.4f}" for k, v in rep.items()))
        elapsed = time.time() - start
        if ckpt_mgr is not None:
            # final save + durability barrier + goodput gauge
            ckpt_mgr.finalize(elapsed_s=elapsed, steps=executed)
        reg.inc("flash_bwd.launches", flash_bwd.launches - launched[0])
        reg.inc("fused_adam.launches", fused_adam_multi.launches - launched[1])
        # throughput counts only the samples this run processed
        thr = bs * executed / elapsed
        if verbose:
            print(f"ELAPSED TIME = {elapsed:.4f}s, THROUGHPUT = {thr:.2f} "
                  f"samples/s")
        return thr

    def _batches(self, x, batch_size):
        xs = x if isinstance(x, (list, tuple)) else [x]
        bs = batch_size or self.input_tensors[0].shape[0]
        if xs[0].shape[0] // bs == 0:
            raise ValueError(f"dataset of {xs[0].shape[0]} samples is "
                             f"smaller than batch size {bs}")
        return xs, bs, xs[0].shape[0] // bs

    def fit(self, x=None, y=None, batch_size: Optional[int] = None,
            epochs: Optional[int] = None, verbose: bool = True,
            trace_dir: Optional[str] = None,
            profile_steps: Optional[str] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: Optional[int] = None,
            resume: Optional[bool] = None) -> float:
        """Keras-style whole-dataset training loop, streaming batches from
        the host; returns samples/s.

        ``checkpoint_dir`` + ``checkpoint_every`` (or the
        ``--checkpoint-*`` flags) turn on v2 per-shard async
        checkpointing (``flexflow_tpu_torch/ckpt``): every N iterations
        the step's state is snapshotted to the host (the only blocking
        cost) and a writer thread commits it manifest-last, keeping the
        newest ``--checkpoint-retain`` checkpoints. ``resume`` (or
        ``--resume``) restores the newest complete checkpoint first and
        skips the step slots it covers, so ``epochs`` keeps meaning the
        TOTAL schedule: an interrupted and an uninterrupted run of the
        same command line end bit-identically. ``--grace-window`` and
        ``--watchdog-timeout`` supervise the run (``runtime_health.py``).

        ``trace_dir`` (or ``--trace-dir``) turns on the observability of
        ``obs/``: per-step Chrome-trace/JSONL artifacts, the step summary
        (FLOPs, peak memory, collective census), the simulated schedule
        and the drift report land in that directory when the loop ends,
        also when it raises (then the trace and counters only).
        ``profile_steps`` (or ``--profile-steps``, e.g. "2:4") wraps that
        window of steps in a ``torch.profiler`` session whose device time
        by step and kernel lands there too (``.devtrace.json``). Without
        ``trace_dir`` nothing is written and the steps run as before."""
        if self.executor is None:
            raise ValueError("compile() the model before fit()")
        epochs = epochs or self.config.epochs
        xs, bs, num_batches = self._batches(x, batch_size)
        tracer = self._make_tracer(trace_dir, "fit")
        devtrace = self._make_capture(tracer, profile_steps)

        def next_batch(epoch, b):
            sl = slice(b * bs, (b + 1) * bs)
            with tracer.phase("data_load"):
                host = [xx[sl] for xx in xs]
                labels = y[sl]
            # the compiled step copies the host batch to the card: here it
            # only takes the model's input dtypes
            with tracer.phase("device_put"):
                return self._host_inputs(host), np.asarray(labels)

        run_name = tracer.run_name if tracer.active else "fit"
        health = self._make_health(tracer, devtrace, run_name=run_name)
        try:
            if health is not None:
                health.install()
            ckpt_mgr, start_step = self._make_checkpointer(
                checkpoint_dir, checkpoint_every, resume,
                heartbeat=health.heartbeat if health is not None else None)
            out = self._run_epochs(next_batch, num_batches, bs, epochs,
                                   verbose, ckpt_mgr=ckpt_mgr,
                                   start_step=start_step, health=health,
                                   tracer=tracer, devtrace=devtrace)
        except BaseException:
            self._finalize_trace(tracer, success=False, devtrace=devtrace)
            raise
        finally:
            if health is not None:
                health.close()
        self._finalize_trace(tracer, devtrace=devtrace)
        return out

    def fit_loader(self, loaders, epochs: Optional[int] = None,
                   verbose: bool = True, trace_dir: Optional[str] = None,
                   profile_steps: Optional[str] = None,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: Optional[int] = None,
                   resume: Optional[bool] = None) -> float:
        """``fit`` over staged loaders (``dataloader.DataLoaderSet``):
        each step takes its batch as a slice of the staged dataset, copied
        into the compiled step's static feeds on the device, so a
        steady-state step moves no host bytes to the card. The loaders
        reset at each epoch; every checkpoint's manifest records their
        cursor (``client_state["loader"]``), and a resume seeks them once
        to the first batch the checkpoint does not cover. The tracer,
        health and checkpoint arguments are ``fit``'s."""
        if self.executor is None:
            raise ValueError("compile() the model before fit_loader()")
        epochs = epochs or self.config.epochs
        bs = loaders.input_loaders[0].batch_size
        tracer = self._make_tracer(trace_dir, "fit")
        devtrace = self._make_capture(tracer, profile_steps)

        def next_batch(epoch, b):
            with tracer.phase("data_load"):
                return loaders.next_batch()

        def cursor():
            nb = loaders.num_batches
            return dict(loader=dict(iteration=int(self._iter),
                                    epoch=int(self._iter // nb),
                                    batch=int(self._iter % nb),
                                    num_batches=int(nb)))

        run_name = tracer.run_name if tracer.active else "fit"
        health = self._make_health(tracer, devtrace, run_name=run_name)
        try:
            if health is not None:
                health.install()
            ckpt_mgr, start_step = self._make_checkpointer(
                checkpoint_dir, checkpoint_every, resume, run_name=run_name,
                heartbeat=health.heartbeat if health is not None else None,
                state_provider=cursor)
            out = self._run_epochs(
                next_batch, loaders.num_batches, bs, epochs, verbose,
                ckpt_mgr=ckpt_mgr, start_step=start_step, health=health,
                tracer=tracer, devtrace=devtrace,
                on_epoch_start=loaders.reset,
                on_resume=lambda s: loaders.seek(s % loaders.num_batches))
        except BaseException:
            self._finalize_trace(tracer, success=False, devtrace=devtrace)
            raise
        finally:
            if health is not None:
                health.close()
        self._finalize_trace(tracer, devtrace=devtrace)
        return out

    def evaluate(self, x=None, y=None, batch_size: Optional[int] = None,
                 trace_dir: Optional[str] = None) -> Dict[str, float]:
        """Loss and metrics over the dataset -> {metric: mean, "loss":
        mean batch loss}, through the compiled eval step; each batch's
        loss and metric sums are read as the reference reads them.
        ``trace_dir`` (or ``--trace-dir``) writes the batches' spans
        (device_put, dispatch, metrics_sync) as an ``evaluate`` trace."""
        if self.executor is None:
            raise ValueError("compile() the model before evaluate()")
        xs, bs, num_batches = self._batches(x, batch_size)
        eval_step = self.executor.make_eval_step()
        self._refresh_compute_params()
        tracer = self._make_tracer(trace_dir, "evaluate")
        acc = PerfMetrics()
        loss_sum = 0.0
        try:
            for b in range(num_batches):
                with tracer.step():
                    sl = slice(b * bs, (b + 1) * bs)
                    with tracer.phase("device_put"):
                        inputs = self._host_inputs([xx[sl] for xx in xs])
                        labels = np.asarray(y[sl])
                    with tracer.phase("dispatch"):
                        loss, _, mvals = eval_step(self.params, self.state,
                                                   inputs, labels)
                    with tracer.phase("metrics_sync"):
                        loss_sum += float(loss)
                        acc.update(mvals, bs)
        finally:
            if tracer.active:
                try:
                    tracer.export()
                except Exception as e:
                    import sys
                    print(f"[obs] trace export failed: {e!r}",
                          file=sys.stderr)
        rep = acc.report()
        rep["loss"] = loss_sum / num_batches
        return rep

    # ======================= the reference's step-by-step loop ============
    # set_batch; forward; zero_gradients; backward; update: the original
    # FlexFlow's training loop, as the JAX package keeps it. forward and
    # backward only mark the step (and its seq_length); update runs one
    # whole compiled train step (fit's) on the staged batch. A seq_length
    # below the model's sequence extent runs a BUCKET executor: the same
    # layer graph materialized at the next power-of-two length, so every
    # op skips the compute past the active length under a bounded set of
    # captured shapes.
    def set_batch(self, x, y) -> None:
        if self.executor is None:
            raise ValueError("compile() the model before set_batch()")
        self._current_batch = (self._host_inputs(x), np.asarray(y))

    def forward(self, seq_length: Optional[int] = None) -> None:
        """Mark the step; ``seq_length`` below the model's sequence extent
        makes ``update`` run the bucket executor (``_seq_bucket``)."""
        if self._current_batch is None:
            raise ValueError("call set_batch(x, y) before forward()")
        self._iter_seq = seq_length

    def zero_gradients(self) -> None:
        """Nothing to clear: every step takes fresh gradients."""

    def backward(self, seq_length: Optional[int] = None) -> None:
        if seq_length is not None:
            self._iter_seq = seq_length

    def _seq_bucket(self, seq_length: Optional[int]) -> Optional[int]:
        """The bucketed static length of an iteration's ``seq_length``:
        the next power of two (at least 16), or None where the
        full-length step applies (no or a full ``seq_length``, no single
        sequence extent, a graph the search rewrote, a bucket as long as
        the model, or no input carrying the sequence at dim 1)."""
        declared = self._declared_seq()
        if not seq_length or declared is None or seq_length >= declared:
            return None
        if isinstance(self.search_info, dict) \
                and self.search_info.get("rewritten_nodes") is not None:
            return None  # the strategy is keyed to the rewritten graph
        if type(self.executor) is not GraphExecutor:
            return None
        if not any(len(layer.outputs[0].shape) >= 2
                   and layer.outputs[0].shape[1] == declared
                   for layer in self.layers
                   if layer.op_type == OperatorType.INPUT):
            return None
        b = 16
        while b < seq_length:
            b *= 2
        return b if b < declared else None

    def _bucket_executor(self, bucket: int) -> GraphExecutor:
        """The executor of the layer graph materialized at ``bucket``
        sequence length, made once a bucket. It shares the parameters,
        the optimizer state and the op state with the full-length
        executor (layer names and guids are stable, and no parameter
        shape depends on the sequence extent) and has its own compiled
        steps. Raises NotImplementedError for an input carrying the
        sequence extent on more than one dim, and for an op whose
        parameter shape changes at the bucket."""
        ex = self._seq_execs.get(bucket)
        if ex is not None:
            return ex
        from flexflow_tpu_torch.parallel.strategy import _record_strategy
        declared = self._declared_seq()
        overrides = {}
        for layer in self.layers:
            if layer.op_type != OperatorType.INPUT:
                continue
            shp = list(layer.outputs[0].shape)
            if sum(1 for e in shp[1:] if e == declared) > 1:
                raise NotImplementedError(
                    f"seq_length buckets: input '{layer.name}' shape "
                    f"{tuple(shp)} carries the sequence extent on more "
                    f"than one dim (e.g. an [B,S,S] mask): ambiguous to "
                    f"slice")
            if len(shp) >= 2 and shp[1] == declared:
                shp[1] = bucket
                overrides[layer.name] = tuple(shp)
        nodes, input_names, tensor_ref = self._materialize_nodes(overrides)
        final_ref = self._select_final_ref(nodes, tensor_ref)
        full = self.executor
        full_by_guid = {n.op.guid: n.op for n in full.nodes}

        def shapes(op):
            try:
                return {k: tuple(v) for k, v in op.param_shapes().items()}
            except Exception:
                return None

        for n in nodes:
            ref_op = full_by_guid.get(n.op.guid)
            if ref_op is None:
                continue
            mine, ref = shapes(n.op), shapes(ref_op)
            mismatch = (ref_op.params_elems() != n.op.params_elems()
                        if mine is None or ref is None else mine != ref)
            if mismatch:
                raise NotImplementedError(
                    f"seq_length buckets: op '{n.op.name}' changes "
                    f"parameter shape at the bucketed length: an input "
                    f"whose dim 1 coincides with the sequence extent is "
                    f"not a sequence; run full-length instead")
        training = full.comp_mode == CompMode.TRAINING
        _record_strategy(nodes, self.strategy, self.mesh,
                         kernels=self._kernel_mode, training=training,
                         device=self.device)
        propagate_layouts(nodes, mode=self.config.conv_compute_layout,
                          on_accelerator=self.device.type == "cuda")
        ex = GraphExecutor(
            nodes, input_names, final_ref, self.device,
            compute_dtype=full.compute_dtype, loss_type=full.loss_type,
            metrics=full.metrics, optimizer=full.optimizer,
            final_is_softmax=full.final_is_softmax,
            kernel_choices=full.kernel_choices, mesh=full.mesh,
            remat_ops=full.remat_ops, fold_conv_bn=full.fold_conv_bn,
            weight_update_sharding=full.weight_update_sharding,
            wus_ops=full.wus_ops, overlap_grad_sync=full.grad_overlap,
            overlap_bucket_bytes=full.overlap_bucket_bytes)
        ex.comp_mode = full.comp_mode
        self._seq_execs[bucket] = ex
        return ex

    def _slice_seq(self, arr, bucket: int):
        """``arr`` cut to ``bucket`` along dim 1 where dim 1 is the
        model's sequence extent; else as it is."""
        declared = self._declared_seq()
        if arr.ndim >= 2 and arr.shape[1] == declared:
            return arr[:, :bucket]
        return arr

    def _final_output_has_seq(self) -> bool:
        """Whether the model output carries a SEQ dim (a token-level
        model: its labels slice with the sequence; a pooled head keeps
        them whole)."""
        from flexflow_tpu_torch.ops.base import DimRole
        guid, idx = self.executor.final_ref
        node = next(n for n in self.executor.nodes if n.op.guid == guid)
        return DimRole.SEQ in node.op.output_dim_roles()[idx]

    def update(self) -> None:
        """One compiled train step on the staged batch: parameters,
        optimizer state, ``_last_loss`` and ``_last_metrics`` (the step's
        metric sums) as ``fit``'s step leaves them. Under a shorter
        ``seq_length`` the step is the bucket executor's, on the batch
        cut to the bucket (the labels too where the output carries the
        sequence)."""
        if self._current_batch is None:
            raise ValueError("call set_batch(x, y) before update()")
        inputs, labels = self._current_batch
        ex = self.executor
        bucket = self._seq_bucket(self._iter_seq)
        if bucket is not None:
            ex = self._bucket_executor(bucket)
            inputs = {k: self._slice_seq(v, bucket)
                      for k, v in inputs.items()}
            if self._final_output_has_seq():
                labels = self._slice_seq(labels, bucket)
        train_step = ex.make_train_step()
        self._refresh_compute_params()
        (self.params, self.opt_state, self.state, loss,
         mvals) = train_step(self.params, self.opt_state, self.state,
                             inputs, labels, self._generator)
        # the step's outputs are overwritten by its next call
        self._last_metrics = {k: v.clone() for k, v in mvals.items()}
        self._last_loss = float(loss)
        self._iter += 1

    # ======================= inference =====================================
    def begin_trace(self, trace_id: int = 0):
        """No-op: the reference's Legion trace capture; every step here is
        a compiled step already."""

    def end_trace(self, trace_id: int = 0):
        """No-op (``begin_trace``)."""

    def serve(self, batch_buckets=None, max_wait_ms: float = 5.0,
              search_budget: Optional[int] = None, start: bool = False,
              verbose: bool = False):
        """Continuous-batching inference server over this compiled model
        (``flexflow_tpu_torch/serve``). Returns a ``ServingEngine``;
        ``start=True`` also starts its background serving thread."""
        if self.executor is None:
            raise ValueError("compile() the model before serve()")
        if self.executor.multi_rank:
            raise NotImplementedError(
                f"serve() over the mesh {self.mesh.shape}: serving a model "
                f"sharded over a process group is the rest of the "
                f"multi-GPU slice of the PyTorch port (ROADMAP.md Queue 1 "
                f"item 3.3)")
        from flexflow_tpu_torch.serve import ServingEngine
        engine = ServingEngine(self, batch_buckets=batch_buckets,
                               max_wait_ms=max_wait_ms,
                               search_budget=search_budget,
                               verbose=verbose)
        return engine.start() if start else engine

    def predict(self, x) -> np.ndarray:
        """Forward the batch ``x`` (one array per model input) through the
        compiled forward; returns the model output as f32 numpy."""
        self._refresh_compute_params()
        fwd = self.executor.make_forward(training=False)
        return host_copy(fwd(self.params, self.state, self._host_inputs(x)))

    # ---- checkpoint / resume / recompile -----------------------------------
    def save_checkpoint(self, path: str) -> None:
        """The v1 single-file checkpoint (``checkpoint.py``)."""
        from flexflow_tpu_torch.checkpoint import save_checkpoint
        save_checkpoint(path, self)

    def load_checkpoint(self, path: str) -> int:
        """Restore a v1 file stem or a v2 checkpoint directory (either
        package's) into this compiled model, in place; returns the saved
        iteration counter."""
        from flexflow_tpu_torch.checkpoint import load_checkpoint
        return load_checkpoint(path, self)

    def recompile_on_condition(self, recompile_state) -> bool:
        from flexflow_tpu_torch.recompile import recompile_on_condition
        return recompile_on_condition(self, recompile_state)

    # ---- weight I/O --------------------------------------------------------
    def get_parameter(self, layer_name: str, param_name: str = "kernel") -> np.ndarray:
        """The whole parameter leaf, on every rank of a process group (a
        collective there: every rank calls it), gathered from each
        rank's master box (its WUS shard under weight-update
        sharding)."""
        t = self.params[layer_name][param_name]
        return host_copy(self.executor.whole_leaf(layer_name, param_name, t),
                         t.dtype)

    def set_parameter(self, layer_name: str, value: np.ndarray,
                      param_name: str = "kernel") -> None:
        """Write the whole leaf ``value``; over a process group each rank
        keeps its master box of it (its WUS shard under weight-update
        sharding)."""
        old = self.params[layer_name][param_name]
        whole = torch.tensor(np.asarray(value), dtype=old.dtype)
        box = self.executor.local_box(layer_name, param_name, whole)
        if tuple(old.shape) != tuple(box.shape):
            raise ValueError(f"shape mismatch {tuple(old.shape)} vs "
                             f"{tuple(value.shape)}")
        with torch.no_grad():
            old.copy_(box)
        # defer the compute-copy re-cast: per-weight import loops would
        # otherwise cast the whole tree once per weight
        self._compute_params_dirty = True

    def _refresh_compute_params(self) -> None:
        """Re-derive the compute copy after direct parameter writes. Lazy:
        runs once before the next forward, however many writes happened.
        It casts into the compute copy's own tensors, which the compiled
        steps read."""
        if not getattr(self, "_compute_params_dirty", False):
            return
        self._compute_params_dirty = False
        if self.executor is None or not self.executor.keeps_compute_copy:
            return
        copy = self.state.get(COMPUTE_PARAMS_KEY)
        if copy is None:
            self.state[COMPUTE_PARAMS_KEY] = \
                self.executor.cast_compute_copy(self.params)
            return
        if self.executor.weight_update_sharding:
            # the shards gathered anew (a collective: every rank writes
            # its parameters before the next forward)
            fresh = self.executor.cast_compute_copy(self.params)
        else:
            fresh = self.params
        with torch.no_grad():
            for op, sub in copy.items():
                for pn, t in sub.items():
                    if t.is_floating_point() and t is not fresh[op][pn]:
                        t.copy_(fresh[op][pn])

    def get_layer_names(self) -> List[str]:
        return [n.op.name for n in (self.executor.nodes if self.executor else [])]


def host_input(arr, tensor: Tensor) -> np.ndarray:
    """One host array for the model input ``tensor``: integer arrays (token
    ids) in the input's declared integer dtype, so that a compiled step's
    static feed keeps that dtype whatever integer type the caller used;
    anything else as given."""
    arr = np.asarray(arr)
    if arr.dtype.kind in "iu" and tensor.dtype in (DataType.INT32,
                                                   DataType.INT64):
        arr = arr.astype(tensor.dtype.value, copy=False)
    return arr


def stage_array(arr, device: torch.device, compute_dtype: torch.dtype
                ) -> torch.Tensor:
    """One host array on ``device``; floating arrays in ``compute_dtype``."""
    t = torch.as_tensor(np.asarray(arr), device=device)
    return t.to(compute_dtype) if t.is_floating_point() else t


def host_copy(t: torch.Tensor, dtype=torch.float32) -> np.ndarray:
    """A host copy of ``t`` in ``dtype``, never a view: compiled steps
    rewrite their outputs, and training rewrites the parameters, in
    place."""
    return t.detach().to("cpu", dtype, copy=True).numpy()

