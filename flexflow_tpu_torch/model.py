"""FFModel: the user-facing model-building API + inference runtime.

PyTorch counterpart of ``flexflow_tpu/model.py``'s ``FFModel``: the same
deferred layer-building API, a ``compile()`` that materializes operators
from layers, and ``predict`` / ``serve`` over the compiled graph. The
device is explicit: ``FFModel(config, device=...)`` runs on CUDA unless
the caller asks for the CPU, and raises when no CUDA device is present
rather than carry on on the CPU.

In this slice ``compile`` places every op on the one device, with no
search, no mesh and no weight-update sharding, and supports
``CompMode.INFERENCE`` only; training comes with the next slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.executor import (COMPUTE_PARAMS_KEY, GraphExecutor,
                                         OpNode)
from flexflow_tpu_torch.ffconst import (ActiMode, CompMode, DataType,
                                        LossType, MetricsType, OperatorType)
from flexflow_tpu_torch.layer import Layer
from flexflow_tpu_torch.ops import OpRegistry
from flexflow_tpu_torch.ops.attention import MultiHeadAttention
from flexflow_tpu_torch.tensor import Tensor


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: CUDA device 0, or an error when there is
    no CUDA device. The CPU runs only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "PyTorch port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


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

    def _unary(self, op_type, x, name=None, scalar=None, inplace=False):
        layer = self._add_layer(op_type, [x], dict(scalar=scalar, inplace=inplace), name)
        return self._finish(layer)

    def _binary(self, op_type, a, b, name=None):
        layer = self._add_layer(op_type, [a, b], {}, name)
        return self._finish(layer)

    def relu(self, x, inplace=True, name=None):
        return self._unary(OperatorType.RELU, x, name, inplace=inplace)

    def add(self, a, b, name=None):
        return self._binary(OperatorType.EW_ADD, a, b, name)

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

    def compile(self, optimizer=None,
                loss_type: LossType = LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                metrics: Sequence[MetricsType] = (),
                comp_mode: CompMode = CompMode.TRAINING,
                machine_spec=None, mesh=None, outputs=None,
                lint: Optional[str] = None) -> None:
        """Materialize ops, place them on the model's device, initialize
        parameters, and (on CUDA) build the attention kernel."""
        cfg = self.config
        if comp_mode != CompMode.INFERENCE:
            raise NotImplementedError(
                "the PyTorch port compiles comp_mode=CompMode.INFERENCE "
                "only; training comes with the training slice (slice 2)")
        if cfg.search_budget:
            raise NotImplementedError(
                f"search_budget={cfg.search_budget}: the strategy search "
                f"comes with the search slice of the PyTorch port (slice 3)")
        if machine_spec is not None or mesh is not None:
            raise NotImplementedError(
                "machine_spec/mesh: multi-GPU execution comes with the "
                "multi-GPU slice of the PyTorch port (slice 4)")
        if (lint or cfg.lint or "off") != "off":
            raise NotImplementedError(
                "lint: static analysis comes with a later slice of the "
                "PyTorch port")
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
        self.executor = GraphExecutor(nodes, input_names, final_ref,
                                      self.device, compute_dtype=compute_dtype)
        self.params, self.state = self.executor.init_params_and_state(
            self._generator)
        if any(isinstance(n.op, MultiHeadAttention)
               and n.op.selected_impl(self.device) == "flash" for n in nodes):
            # build the kernel here rather than on the serving thread's
            # first batch
            from flexflow_tpu_torch import cuda_build
            cuda_build.load("flash_attn_fwd")

    # ======================= data staging ==================================
    def _stage_inputs(self, xs) -> Dict[str, torch.Tensor]:
        """Host arrays -> device tensors; float inputs in the compute
        dtype (activations flow in it end to end)."""
        if not isinstance(xs, (list, tuple)):
            xs = [xs]
        names = self.executor.input_names
        if len(xs) != len(names):
            raise ValueError(f"model has {len(names)} inputs, got {len(xs)} arrays")
        return {n: stage_array(x, self.device, self.executor.compute_dtype)
                for n, x in zip(names, xs)}

    # ======================= inference =====================================
    def serve(self, batch_buckets=None, max_wait_ms: float = 5.0,
              search_budget: Optional[int] = None, start: bool = False,
              verbose: bool = False):
        """Continuous-batching inference server over this compiled model
        (``flexflow_tpu_torch/serve``). Returns a ``ServingEngine``;
        ``start=True`` also starts its background serving thread."""
        if self.executor is None:
            raise ValueError("compile() the model before serve()")
        from flexflow_tpu_torch.serve import ServingEngine
        engine = ServingEngine(self, batch_buckets=batch_buckets,
                               max_wait_ms=max_wait_ms,
                               search_budget=search_budget,
                               verbose=verbose)
        return engine.start() if start else engine

    def predict(self, x) -> np.ndarray:
        """Forward the batch ``x`` (one array per model input); returns the
        model output as f32 numpy."""
        self._refresh_compute_params()
        fwd = self.executor.make_forward(training=False)
        inputs = self._stage_inputs(x if isinstance(x, (list, tuple)) else [x])
        return fwd(self.params, self.state, inputs).float().cpu().numpy()

    # ---- weight I/O --------------------------------------------------------
    def get_parameter(self, layer_name: str, param_name: str = "kernel") -> np.ndarray:
        return self.params[layer_name][param_name].detach().cpu().numpy()

    def set_parameter(self, layer_name: str, value: np.ndarray,
                      param_name: str = "kernel") -> None:
        old = self.params[layer_name][param_name]
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch {tuple(old.shape)} vs "
                             f"{tuple(value.shape)}")
        with torch.no_grad():
            old.copy_(torch.tensor(np.asarray(value), dtype=old.dtype))
        # defer the compute-copy re-cast: per-weight import loops would
        # otherwise cast the whole tree once per weight
        self._compute_params_dirty = True

    def _refresh_compute_params(self) -> None:
        """Re-derive the compute copy after direct parameter writes. Lazy:
        runs once before the next forward, however many writes happened."""
        if not getattr(self, "_compute_params_dirty", False):
            return
        self._compute_params_dirty = False
        if self.executor is not None and self.executor.use_master_copy:
            self.state[COMPUTE_PARAMS_KEY] = \
                self.executor.cast_compute_copy(self.params)

    def get_layer_names(self) -> List[str]:
        return [n.op.name for n in (self.executor.nodes if self.executor else [])]


def stage_array(arr, device: torch.device, compute_dtype: torch.dtype
                ) -> torch.Tensor:
    """One host array on ``device``; floating arrays in ``compute_dtype``."""
    t = torch.as_tensor(np.asarray(arr), device=device)
    return t.to(compute_dtype) if t.is_floating_point() else t
