"""ONNX graph -> FFModel translation.

PyTorch counterpart of ``flexflow_tpu/onnx/model.py``: walks
``model.graph.node`` in order and emits the port's FFModel layer per ONNX
op_type, sizing Gemm/MatMul/Conv/BatchNorm from the graph's initializer
payloads, so standard exported models load with no custom attributes.
The weights transfer into the compiled model through
:meth:`ONNXModel.copy_weights_to` (BatchNorm's running statistics into
the model's op state).

Accepted inputs: a ``.onnx`` path or raw ModelProto bytes (parsed by the
dependency-free reader in :mod:`flexflow_tpu_torch.onnx.proto`), an
``onnx`` package ModelProto (when that package is importable), or any
duck-typed object with the ModelProto structure.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import torch

from flexflow_tpu_torch.ffconst import PoolType
from flexflow_tpu_torch.model import FFModel


# AttributeProto.AttributeType values (onnx.proto): which field is live
_ATTR_TYPE_FIELD = {1: "f", 2: "i", 3: "s", 4: "t", 6: "floats", 7: "ints"}


def _attrs(node) -> Dict[str, Any]:
    out = {}
    for a in getattr(node, "attribute", []):
        atype = getattr(a, "type", None)
        if atype in _ATTR_TYPE_FIELD:
            # real protobuf: every field exists with a default — the type
            # tag alone decides which one carries the value
            fields = (_ATTR_TYPE_FIELD[atype],)
        else:
            # duck-typed stand-in (tests / no onnx package): first field
            # actually set wins
            fields = ("i", "f", "s", "t", "ints", "floats")
        for field in fields:
            v = getattr(a, field, None)
            if v is None:
                continue
            if field == "s" and isinstance(v, bytes):
                v = v.decode()
            if field in ("ints", "floats"):
                v = list(v)
            if field == "t":
                v = _tensor_to_numpy(v)
            out[a.name] = v
            break
    return out


def _tensor_to_numpy(t) -> np.ndarray:
    """TensorProto (own reader, onnx package, or duck-typed) → ndarray."""
    if isinstance(t, np.ndarray):
        return t
    if hasattr(t, "to_numpy"):
        return t.to_numpy()
    try:
        from onnx import numpy_helper  # pragma: no cover

        return numpy_helper.to_array(t)
    except ImportError:
        pass
    from flexflow_tpu_torch.onnx.proto import TENSOR_DTYPES

    dtype = TENSOR_DTYPES.get(getattr(t, "data_type", 1), np.float32)
    shape = tuple(getattr(t, "dims", ()))
    raw = getattr(t, "raw_data", b"")
    if raw:
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    for field in ("float_data", "int64_data", "int32_data", "double_data"):
        data = list(getattr(t, field, []) or [])
        if data:
            return np.asarray(data, dtype=dtype).reshape(shape)
    return np.zeros(shape, dtype=dtype)


class ONNXModel:
    def __init__(self, model):
        if isinstance(model, (str, bytes)):
            if isinstance(model, str):
                with open(model, "rb") as f:
                    model = f.read()
            from flexflow_tpu_torch.onnx.proto import parse_model

            model = parse_model(model)
        self.model = model
        # initializer payloads: name -> ndarray (the reference reads these
        # to size Gemm/Conv and we additionally keep them for weight import)
        self.initializers: Dict[str, np.ndarray] = {}
        for t in getattr(model.graph, "initializer", []):
            self.initializers[t.name] = _tensor_to_numpy(t)
        # layer name -> {ff param name: ndarray} staged for copy_weights_to
        self._imports: Dict[str, Dict[str, np.ndarray]] = {}
        # layer name -> {state name: ndarray} (BatchNorm running stats live
        # in the model's non-trainable state collection, not params)
        self._state_imports: Dict[str, Dict[str, np.ndarray]] = {}

    # ---- graph walk --------------------------------------------------------
    def apply(self, ff: FFModel, input_tensors: Dict[str, Any]):
        """Translate the graph; returns the tensor of the last node output.

        ``input_tensors`` maps ONNX graph-input names to FFModel tensors.
        """
        env: Dict[str, Any] = dict(input_tensors)
        out = None
        for node in self.model.graph.node:
            out = self._emit(ff, node, env)
        return out

    def copy_weights_to(self, ff: FFModel) -> int:
        """After ``ff.compile``: load the ONNX initializer weights into the
        model's parameters, and BatchNorm's running statistics into its
        op state. Returns the number of arrays copied."""
        copied = 0
        for layer_name, params in self._imports.items():
            for pname, arr in params.items():
                try:
                    ff.set_parameter(layer_name, arr, pname)
                    copied += 1
                except (KeyError, ValueError):
                    pass  # layer absent after rewrites / shape mismatch
        for layer_name, stats in self._state_imports.items():
            st = ff.state.get(layer_name)
            if st is None:
                continue
            for sname, arr in stats.items():
                old = st.get(sname)
                if old is None or tuple(old.shape) != tuple(arr.shape):
                    continue
                with torch.no_grad():
                    old.copy_(torch.as_tensor(arr, dtype=old.dtype))
                copied += 1
        return copied

    def _weights(self, node) -> List[Optional[np.ndarray]]:
        """Initializer payload per node input (None for activations)."""
        return [self.initializers.get(i) for i in node.input]

    def _emit(self, ff: FFModel, node, env: Dict[str, Any]):
        op = node.op_type
        at = _attrs(node)
        # data inputs only (weights come from initializers)
        ins = [env[i] for i in node.input if i in env]
        wts = self._weights(node)
        name = node.output[0]

        def done(t):
            env[name] = t
            return t

        if op == "Constant":
            value = at.get("value")
            if value is None:
                raise ValueError(f"Constant {name}: no tensor attribute")
            self.initializers[name] = np.asarray(value)
            return None
        if op == "Gemm" or op == "MatMul":
            if op == "Gemm" and at.get("transA", 0):
                # dense computes x @ W; transposing the activation is not
                # expressible as a weight fold — refuse rather than silently
                # computing wrong numerics
                raise NotImplementedError(
                    f"Gemm node {name}: transA=1 is not supported")
            w = next((w for w in wts[1:] if w is not None and w.ndim == 2),
                     None)
            if w is not None:
                trans_b = bool(at.get("transB", 0)) if op == "Gemm" else False
                kernel = w.T if trans_b else w  # ff dense kernel: [in, out]
                out_dim = kernel.shape[1]
                bias = next((b for b in wts[1:]
                             if b is not None and b.ndim == 1), None)
                # Gemm computes alpha*(A@B) + beta*C — fold both scalars
                # into the imported weights so numerics match exactly
                alpha = float(at.get("alpha", 1.0)) if op == "Gemm" else 1.0
                beta = float(at.get("beta", 1.0)) if op == "Gemm" else 1.0
                t = ff.dense(ins[0], int(out_dim),
                             use_bias=bias is not None, name=name)
                imp = {"kernel": np.ascontiguousarray(
                    kernel, dtype=np.float32) * alpha}
                if bias is not None:
                    imp["bias"] = np.asarray(bias, dtype=np.float32) * beta
                self._imports[name] = imp
                return done(t)
            # no initializer (dynamic weight or legacy stand-in): fall back
            # to the explicit attribute the pre-initializer frontend used
            out_dim = at.get("out_dim") or at.get("N")
            if out_dim is None:
                raise ValueError(
                    f"{op} node {name}: weight initializer not found and no "
                    f"'out_dim' attribute given")
            return done(ff.dense(ins[0], int(out_dim),
                                 use_bias=(op == "Gemm"), name=name))
        if op == "Conv":
            w = wts[1] if len(wts) > 1 else None
            if w is not None and w.ndim == 4:
                out_ch = w.shape[0]  # OIHW, matches ff conv2d kernel layout
                k = at.get("kernel_shape", list(w.shape[2:]))
                imp = {"kernel": np.asarray(w, dtype=np.float32)}
                bias = wts[2] if len(wts) > 2 else None
                if bias is not None:
                    imp["bias"] = np.asarray(bias, dtype=np.float32)
                self._imports[name] = imp
            else:
                k = at.get("kernel_shape", [1, 1])
                out_ch = at.get("out_channels")
                bias = None
                if out_ch is None:
                    raise ValueError(
                        f"Conv node {name}: weight initializer not found "
                        f"and no 'out_channels' attribute given")
            s = at.get("strides", [1, 1])
            p = at.get("pads", [0, 0, 0, 0])
            return done(ff.conv2d(ins[0], int(out_ch), k[0], k[1], s[0], s[1],
                                  p[0], p[1], groups=int(at.get("group", 1)),
                                  use_bias=(w is None or len(wts) > 2),
                                  name=name))
        if op in ("MaxPool", "AveragePool"):
            k = at.get("kernel_shape", [2, 2])
            s = at.get("strides", k)
            p = at.get("pads", [0, 0, 0, 0])
            pt = PoolType.POOL_MAX if op == "MaxPool" else PoolType.POOL_AVG
            return done(ff.pool2d(ins[0], k[0], k[1], s[0], s[1], p[0], p[1],
                                  pool_type=pt, name=name))
        if op == "GlobalAveragePool":
            return done(ff.mean(ins[0], [2, 3], keepdims=True, name=name))
        if op == "BatchNormalization":
            # inputs: X, scale, B, input_mean, input_var (onnx.proto)
            t = ff.batch_norm(ins[0], relu=False, name=name)
            if len(wts) >= 3 and wts[1] is not None and wts[2] is not None:
                self._imports[name] = {
                    "scale": np.asarray(wts[1], dtype=np.float32),
                    "bias": np.asarray(wts[2], dtype=np.float32),
                }
            if len(wts) >= 5 and wts[3] is not None and wts[4] is not None:
                # trained running stats: inference must use them, not the
                # init-state defaults (mean=0, var=1)
                self._state_imports[name] = {
                    "mean": np.asarray(wts[3], dtype=np.float32),
                    "var": np.asarray(wts[4], dtype=np.float32),
                }
            return done(t)
        if op == "LayerNormalization":
            t = ff.layer_norm(ins[0], name=name)
            if len(wts) >= 2 and wts[1] is not None:
                imp = {"scale": np.asarray(wts[1], dtype=np.float32)}
                if len(wts) >= 3 and wts[2] is not None:
                    imp["bias"] = np.asarray(wts[2], dtype=np.float32)
                self._imports[name] = imp
            return done(t)
        if op == "Relu":
            return done(ff.relu(ins[0], name=name))
        if op == "Gelu":
            return done(ff.gelu(ins[0], name=name))
        if op == "Sigmoid":
            return done(ff.sigmoid(ins[0], name=name))
        if op == "Tanh":
            return done(ff.tanh(ins[0], name=name))
        if op == "Elu":
            return done(ff.elu(ins[0], name=name))
        if op == "Exp":
            return done(ff.exp(ins[0], name=name))
        if op == "Softmax":
            return done(ff.softmax(ins[0], axis=int(at.get("axis", -1)),
                                   name=name))
        if op == "Dropout":
            return done(ff.dropout(ins[0], float(at.get("ratio", 0.5)),
                                   name=name))
        if op == "Add":
            return done(ff.add(ins[0], ins[1], name=name))
        if op == "Sub":
            return done(ff.subtract(ins[0], ins[1], name=name))
        if op == "Mul":
            return done(ff.multiply(ins[0], ins[1], name=name))
        if op == "Div":
            return done(ff.divide(ins[0], ins[1], name=name))
        if op == "Max":
            return done(ff.max(ins[0], ins[1], name=name))
        if op == "Min":
            return done(ff.min(ins[0], ins[1], name=name))
        if op == "Concat":
            return done(ff.concat(ins, int(at.get("axis", 0)), name=name))
        if op == "Split":
            sizes = at.get("split")
            if sizes is None and len(node.input) > 1:
                arr = self.initializers.get(node.input[1])
                if arr is not None:  # opset >= 13: sizes as constant input
                    sizes = [int(x) for x in arr]
            outs = ff.split(ins[0], sizes if sizes else len(node.output),
                            int(at.get("axis", 0)), name=name)
            for out_name, t in zip(node.output, outs):
                env[out_name] = t
            return outs
        if op == "Flatten":
            return done(ff.flat(ins[0], name=name))
        if op == "Reshape":
            shape = at.get("shape")
            if shape is None and len(node.input) > 1:
                arr = self.initializers.get(node.input[1])
                if arr is not None:  # standard export: shape as constant
                    shape = [int(x) for x in arr]
            if shape is None:
                raise ValueError(f"Reshape {name}: shape neither attribute "
                                 f"nor constant initializer")
            batch = ins[0].shape[0]
            shape = [batch if s in (0, -1) and i == 0 else int(s)
                     for i, s in enumerate(shape)]
            return done(ff.reshape(ins[0], shape, name=name))
        if op == "Transpose":
            return done(ff.transpose(ins[0], at.get("perm"), name=name))
        if op == "Cast":
            return done(ff.identity(ins[0], name=name))
        if op == "ReduceMean":
            return done(ff.mean(ins[0], at.get("axes", [-1]),
                                keepdims=bool(at.get("keepdims", 1)),
                                name=name))
        if op == "ReduceSum":
            return done(ff.reduce_sum(ins[0], at.get("axes", [-1]),
                                      keepdims=bool(at.get("keepdims", 1)),
                                      name=name))
        if op == "Gather":
            return done(ff.gather(ins[0], ins[1], axis=int(at.get("axis", 0)),
                                  name=name))
        if op == "Identity":
            return done(ff.identity(ins[0], name=name))
        raise NotImplementedError(f"ONNX op {op} has no translation")
