"""Keras-compatible layer objects.

PyTorch counterpart of ``flexflow_tpu/keras/layers.py``: each layer is a
deferred config object; calling it on a symbolic tensor records an edge in
the Keras graph, and ``Model.compile`` translates the graph into the
port's FFModel layer calls. ``Dense`` takes ``kernel_initializer`` /
``bias_initializer`` (``flexflow_tpu_torch.initializers``), which draw
from the model's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType, PoolType

_ACTIVATIONS = {
    None: ActiMode.AC_MODE_NONE,
    "linear": ActiMode.AC_MODE_NONE,
    "relu": ActiMode.AC_MODE_RELU,
    "sigmoid": ActiMode.AC_MODE_SIGMOID,
    "tanh": ActiMode.AC_MODE_TANH,
    "gelu": ActiMode.AC_MODE_GELU,
}


def _acti(name) -> ActiMode:
    if isinstance(name, ActiMode):
        return name
    if name == "softmax":  # handled as a separate trailing op
        return ActiMode.AC_MODE_NONE
    if name not in _ACTIVATIONS:
        raise ValueError(f"unsupported activation {name!r}")
    return _ACTIVATIONS[name]


def _pair(v) -> Tuple[int, int]:
    return (v,) * 2 if isinstance(v, int) else tuple(v)


class KTensor:
    """Symbolic tensor in the Keras-level graph."""

    def __init__(self, shape: Tuple[int, ...], producer: Optional["KLayer"],
                 producer_idx: int = 0):
        # includes the batch dim (None: set at compile)
        self.shape = tuple(shape)
        self.producer = producer
        self.producer_idx = producer_idx


class KLayer:
    """Base layer: records inbound tensors on call; emits FFModel ops later."""

    _counter: Dict[str, int] = {}

    def __init__(self, name: Optional[str] = None):
        base = type(self).__name__.lower()
        if name is None:
            KLayer._counter[base] = KLayer._counter.get(base, 0) + 1
            name = f"{base}_{KLayer._counter[base]}"
        self.name = name
        self.inbound: List[KTensor] = []
        self.outputs: List[KTensor] = []
        self._ff_layer_name: Optional[str] = None  # set at compile

    # shape inference given input shapes (with concrete batch)
    def output_shape(self, input_shapes: List[Tuple[int, ...]]
                     ) -> Tuple[int, ...]:
        return input_shapes[0]

    def __call__(self, inputs):
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self.inbound = list(ins)
        out_shape = self.output_shape([t.shape for t in ins])
        out = KTensor(out_shape, self, 0)
        self.outputs = [out]
        return out

    # emit: build the corresponding FFModel op(s); returns output Tensor
    def emit(self, ff, inputs):
        raise NotImplementedError

    def get_weights(self, ffmodel=None):
        model = ffmodel or getattr(self, "_model", None)
        names = self._param_names()
        return [model.ff.get_parameter(self._ff_layer_name, n) for n in names]

    def set_weights(self, weights, ffmodel=None):
        model = ffmodel or getattr(self, "_model", None)
        for n, w in zip(self._param_names(), weights):
            model.ff.set_parameter(self._ff_layer_name, w, n)

    def _param_names(self):
        return []


class InputLayer(KLayer):
    def __init__(self, shape: Sequence[int], dtype="float32", name=None):
        super().__init__(name)
        self.shape = tuple(shape)
        self.dtype = DataType(dtype) if isinstance(dtype, str) else dtype
        self.outputs = [KTensor((None,) + self.shape, self, 0)]

    @property
    def output(self):
        return self.outputs[0]


def Input(shape: Sequence[int], dtype="float32", name=None) -> KTensor:
    return InputLayer(shape, dtype, name).output


class Dense(KLayer):
    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 kernel_initializer=None, bias_initializer=None, name=None):
        super().__init__(name)
        self.units = units
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer

    def output_shape(self, input_shapes):
        return input_shapes[0][:-1] + (self.units,)

    def emit(self, ff, inputs):
        t = ff.dense(inputs[0], self.units, activation=_acti(self.activation),
                     use_bias=self.use_bias,
                     kernel_initializer=self.kernel_initializer,
                     bias_initializer=self.bias_initializer, name=self.name)
        if self.activation == "softmax":
            t = ff.softmax(t, name=f"{self.name}_softmax")
        return t

    def _param_names(self):
        return ["kernel", "bias"] if self.use_bias else ["kernel"]


class Conv2D(KLayer):
    """NCHW, the Keras frontend's channel-first layout."""

    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding="valid", activation=None, groups: int = 1,
                 use_bias: bool = True, name=None):
        super().__init__(name)
        self.filters = filters
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.activation = activation
        self.groups = groups
        self.use_bias = use_bias

    def _pads(self):
        if self.padding == "same":
            return (self.kernel_size[0] // 2, self.kernel_size[1] // 2)
        if self.padding == "valid":
            return (0, 0)
        return tuple(self.padding)

    def output_shape(self, input_shapes):
        n, c, h, w = input_shapes[0]
        ph, pw = self._pads()
        oh = (h + 2 * ph - self.kernel_size[0]) // self.strides[0] + 1
        ow = (w + 2 * pw - self.kernel_size[1]) // self.strides[1] + 1
        return (n, self.filters, oh, ow)

    def emit(self, ff, inputs):
        ph, pw = self._pads()
        t = ff.conv2d(inputs[0], self.filters, self.kernel_size[0],
                      self.kernel_size[1], self.strides[0], self.strides[1],
                      ph, pw, activation=_acti(self.activation),
                      groups=self.groups, use_bias=self.use_bias,
                      name=self.name)
        if self.activation == "softmax":
            t = ff.softmax(t, name=f"{self.name}_softmax")
        return t

    def _param_names(self):
        return ["kernel", "bias"] if self.use_bias else ["kernel"]


class _Pool2D(KLayer):
    pool_type = PoolType.POOL_MAX

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid",
                 name=None):
        super().__init__(name)
        self.pool_size = _pair(pool_size)
        strides = strides or self.pool_size
        self.strides = _pair(strides)
        self.padding = padding

    def _pads(self):
        if self.padding == "same":
            return (self.pool_size[0] // 2, self.pool_size[1] // 2)
        return (0, 0)

    def output_shape(self, input_shapes):
        n, c, h, w = input_shapes[0]
        ph, pw = self._pads()
        oh = (h + 2 * ph - self.pool_size[0]) // self.strides[0] + 1
        ow = (w + 2 * pw - self.pool_size[1]) // self.strides[1] + 1
        return (n, c, oh, ow)

    def emit(self, ff, inputs):
        ph, pw = self._pads()
        return ff.pool2d(inputs[0], self.pool_size[0], self.pool_size[1],
                         self.strides[0], self.strides[1], ph, pw,
                         pool_type=self.pool_type, name=self.name)


class MaxPooling2D(_Pool2D):
    pool_type = PoolType.POOL_MAX


class AveragePooling2D(_Pool2D):
    pool_type = PoolType.POOL_AVG


class Flatten(KLayer):
    def output_shape(self, input_shapes):
        s = input_shapes[0]
        n = 1
        for d in s[1:]:
            n *= d
        return (s[0], n)

    def emit(self, ff, inputs):
        return ff.flat(inputs[0], name=self.name)


class Activation(KLayer):
    def __init__(self, activation, name=None):
        super().__init__(name)
        self.activation = activation

    def emit(self, ff, inputs):
        a = self.activation
        fn = {"relu": ff.relu, "sigmoid": ff.sigmoid, "tanh": ff.tanh,
              "gelu": ff.gelu, "elu": ff.elu, "exp": ff.exp,
              "softmax": ff.softmax, "linear": ff.identity}.get(a)
        if fn is None:
            raise ValueError(f"unsupported activation {a!r}")
        return fn(inputs[0], name=self.name)


class Dropout(KLayer):
    def __init__(self, rate: float, seed: int = 0, name=None):
        super().__init__(name)
        self.rate = rate
        self.seed = seed

    def emit(self, ff, inputs):
        return ff.dropout(inputs[0], self.rate, self.seed, name=self.name)


class BatchNormalization(KLayer):
    def __init__(self, relu: bool = False, name=None):
        super().__init__(name)
        self.relu = relu

    def emit(self, ff, inputs):
        return ff.batch_norm(inputs[0], relu=self.relu, name=self.name)


class LayerNormalization(KLayer):
    def __init__(self, axis=-1, epsilon: float = 1e-5, name=None):
        super().__init__(name)
        self.axis = axis if isinstance(axis, (list, tuple)) else (axis,)
        self.epsilon = epsilon

    def emit(self, ff, inputs):
        return ff.layer_norm(inputs[0], axes=self.axis, eps=self.epsilon,
                             name=self.name)


class Embedding(KLayer):
    def __init__(self, input_dim: int, output_dim: int, name=None):
        super().__init__(name)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def output_shape(self, input_shapes):
        return input_shapes[0] + (self.output_dim,)

    def emit(self, ff, inputs):
        return ff.embedding(inputs[0], self.input_dim, self.output_dim,
                            aggr=AggrMode.AGGR_MODE_NONE, name=self.name)

    def _param_names(self):
        return ["kernel"]


class Concatenate(KLayer):
    def __init__(self, axis: int = -1, name=None):
        super().__init__(name)
        self.axis = axis

    def output_shape(self, input_shapes):
        ax = self.axis % len(input_shapes[0])
        out = list(input_shapes[0])
        out[ax] = sum(s[ax] for s in input_shapes)
        return tuple(out)

    def emit(self, ff, inputs):
        return ff.concat(inputs, self.axis, name=self.name)


class _Merge(KLayer):
    op = "add"

    def emit(self, ff, inputs):
        fn = {"add": ff.add, "subtract": ff.subtract,
              "multiply": ff.multiply, "maximum": ff.max,
              "minimum": ff.min}[self.op]
        return fn(inputs[0], inputs[1], name=self.name)


class Add(_Merge):
    op = "add"


class Subtract(_Merge):
    op = "subtract"


class Multiply(_Merge):
    op = "multiply"


class Maximum(_Merge):
    op = "maximum"


class Minimum(_Merge):
    op = "minimum"


class Reshape(KLayer):
    def __init__(self, target_shape, name=None):
        super().__init__(name)
        self.target_shape = tuple(target_shape)

    def output_shape(self, input_shapes):
        return (input_shapes[0][0],) + self.target_shape

    def emit(self, ff, inputs):
        batch = inputs[0].shape[0]
        return ff.reshape(inputs[0], (batch,) + self.target_shape,
                          name=self.name)


class MultiHeadAttention(KLayer):
    """Self/cross attention; called as layer([q, k, v]) or layer(x) for
    self-attention."""

    def __init__(self, num_heads: int, key_dim: int, use_bias: bool = True,
                 dropout: float = 0.0, causal: bool = False, name=None):
        super().__init__(name)
        self.num_heads = num_heads
        self.key_dim = key_dim
        self.use_bias = use_bias
        self.dropout = dropout
        self.causal = causal

    def __call__(self, inputs):
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs] * 3
        if len(ins) == 2:
            ins = [ins[0], ins[1], ins[1]]
        return super().__call__(ins)

    def output_shape(self, input_shapes):
        return input_shapes[0]

    def emit(self, ff, inputs):
        embed_dim = self.num_heads * self.key_dim
        return ff.multihead_attention(
            inputs[0], inputs[1], inputs[2], embed_dim, self.num_heads,
            dropout=self.dropout, bias=self.use_bias, causal=self.causal,
            name=self.name)

    def _param_names(self):
        return ["wq", "wk", "wv", "wo"]
