"""Keras Model / Sequential driving the port's FFModel runtime.

PyTorch counterpart of ``flexflow_tpu/keras/models.py``: ``compile()``
walks the symbolic layer graph and replays it onto an ``FFModel`` on the
model's device (the card unless the caller asks for the CPU with
``device="cpu"``); ``fit`` / ``evaluate`` / ``predict`` drive its compiled
steps, with Keras-style callbacks invoked per epoch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from flexflow_tpu_torch import optimizers as ff_optimizers
from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import LossType, MetricsType
from flexflow_tpu_torch.keras.layers import InputLayer, KLayer, KTensor
from flexflow_tpu_torch.model import FFModel

_LOSSES = {
    "categorical_crossentropy": LossType.CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
}

_METRICS = {
    "accuracy": MetricsType.ACCURACY,
    "categorical_crossentropy": MetricsType.CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.MEAN_SQUARED_ERROR,
    "mse": MetricsType.MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.MEAN_ABSOLUTE_ERROR,
}


def _to_ff_optimizer(opt):
    if isinstance(opt, ff_optimizers.Optimizer):
        return opt
    if isinstance(opt, str):
        name = opt.lower()
        if name == "sgd":
            return ff_optimizers.SGDOptimizer(lr=0.01)
        if name == "adam":
            return ff_optimizers.AdamOptimizer(alpha=0.001)
        raise ValueError(f"unknown optimizer {opt!r}")
    # keras-style wrapper objects from flexflow_tpu_torch.keras.optimizers
    if hasattr(opt, "to_ff"):
        return opt.to_ff()
    raise TypeError(f"cannot interpret optimizer {opt!r}")


class Model:
    """Functional-API model: Model(inputs=..., outputs=...). ``device``:
    where ``compile`` builds the FFModel (None: the card)."""

    def __init__(self, inputs=None, outputs=None, name: Optional[str] = None,
                 ffconfig: Optional[FFConfig] = None, device=None):
        self.name = name or "model"
        self.inputs: List[KTensor] = (
            inputs if isinstance(inputs, (list, tuple)) else [inputs]
        ) if inputs is not None else []
        self.outputs: List[KTensor] = (
            outputs if isinstance(outputs, (list, tuple)) else [outputs]
        ) if outputs is not None else []
        self.ffconfig = ffconfig
        self.device = device
        self.ff: Optional[FFModel] = None
        self.layers: List[KLayer] = []
        self._batch_size: Optional[int] = None

    # ---- graph walk --------------------------------------------------------
    def _toposort(self) -> List[KLayer]:
        order: List[KLayer] = []
        seen = set()

        def visit(t: KTensor):
            layer = t.producer
            if layer is None or id(layer) in seen:
                return
            seen.add(id(layer))
            if not isinstance(layer, InputLayer):
                for src in layer.inbound:
                    visit(src)
            order.append(layer)

        for out in self.outputs:
            visit(out)
        return order

    def compile(self, optimizer="sgd", loss="sparse_categorical_crossentropy",
                metrics: Sequence[str] = (), batch_size: Optional[int] = None,
                **kwargs):
        bs = batch_size or (self.ffconfig.batch_size if self.ffconfig else 64)
        self._batch_size = bs
        cfg = self.ffconfig or FFConfig(batch_size=bs)
        ff = FFModel(cfg, device=self.device)
        tensor_map: Dict[int, Any] = {}
        order = self._toposort()
        self.layers = order
        for layer in order:
            layer._model = self
            if isinstance(layer, InputLayer):
                t = ff.create_tensor((bs,) + layer.shape, dtype=layer.dtype,
                                     name=layer.name)
                tensor_map[id(layer.outputs[0])] = t
                layer._ff_layer_name = layer.name
                continue
            ins = [tensor_map[id(src)] for src in layer.inbound]
            out = layer.emit(ff, ins)
            outs = out if isinstance(out, tuple) else (out,)
            for kt, t in zip(layer.outputs, outs):
                tensor_map[id(kt)] = t
            # parameters are keyed by the FFModel layer that owns them —
            # for Dense/Conv with activation='softmax' that is the layer's
            # own name, not the trailing softmax op's
            if layer._param_names():
                layer._ff_layer_name = layer.name
            else:
                first = outs[0]
                layer._ff_layer_name = (
                    first.owner_layer.name if first.owner_layer
                    else layer.name)

        loss_type = _LOSSES[loss] if isinstance(loss, str) else loss
        mts = [_METRICS[m] if isinstance(m, str) else m for m in metrics]
        ff.compile(_to_ff_optimizer(optimizer), loss_type, mts, **kwargs)
        self.ff = ff

    # ---- train / eval ------------------------------------------------------
    def fit(self, x, y, batch_size: Optional[int] = None, epochs: int = 1,
            callbacks: Sequence = (), verbose: bool = True,
            validation_data=None):
        if self.ff is None:
            raise RuntimeError("call compile() before fit()")
        history = {"loss": [], "throughput": []}
        for cb in callbacks:
            cb.set_model(self)
            cb.on_train_begin()
        stop = False
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            thr = self.ff.fit(x, y, batch_size=batch_size, epochs=1,
                              verbose=verbose)
            logs = dict(self.ff._metrics_acc.report())
            logs["loss"] = self.ff._last_loss
            history["loss"].append(logs["loss"])
            history["throughput"].append(thr)
            if validation_data is not None:
                val = self.evaluate(*validation_data, verbose=False)
                logs.update({f"val_{k}": v for k, v in val.items()})
            for cb in callbacks:
                if cb.on_epoch_end(epoch, logs) is False:
                    stop = True
            if stop:
                break
        for cb in callbacks:
            cb.on_train_end()
        return history

    def evaluate(self, x, y, batch_size: Optional[int] = None, verbose=True):
        rep = self.ff.evaluate(x, y, batch_size=batch_size)
        if verbose:
            print(" ".join(f"{k}={v:.4f}" for k, v in rep.items()))
        return rep

    def predict(self, x, batch_size: Optional[int] = None):
        bs = self._batch_size
        xs = x if isinstance(x, (list, tuple)) else [x]
        n = xs[0].shape[0]
        outs = []
        for start in range(0, n, bs):
            sl = [xx[start:start + bs] for xx in xs]
            if sl[0].shape[0] < bs:  # pad the tail to the compiled batch
                pad = bs - sl[0].shape[0]
                sl = [np.concatenate(
                    [s, np.repeat(s[-1:], pad, axis=0)], axis=0) for s in sl]
                outs.append(self.ff.predict(sl)[:bs - pad])
            else:
                outs.append(self.ff.predict(sl))
        return np.concatenate(outs, axis=0)

    def summary(self):
        lines = [f'Model: "{self.name}"', "_" * 60]
        for layer in self.layers:
            shape = layer.outputs[0].shape if layer.outputs else None
            lines.append(f"{layer.name:30s} {type(layer).__name__:20s} "
                         f"{shape}")
        print("\n".join(lines))

    def get_weights(self):
        return [w for l in self.layers for w in
                (l.get_weights(self) if l._param_names() else [])]


class Sequential(Model):
    """Linear layer stack."""

    def __init__(self, layers: Sequence[KLayer] = (), name=None,
                 ffconfig: Optional[FFConfig] = None, device=None):
        super().__init__(name=name or "sequential", ffconfig=ffconfig,
                         device=device)
        self._stack: List[KLayer] = []
        for l in layers:
            self.add(l)

    def add(self, layer: KLayer):
        self._stack.append(layer)

    def compile(self, optimizer="sgd", loss="sparse_categorical_crossentropy",
                metrics: Sequence[str] = (),
                input_shape: Optional[Sequence[int]] = None,
                batch_size: Optional[int] = None, **kwargs):
        stack = list(self._stack)
        if isinstance(stack[0], KTensor):  # Input(...) returns a KTensor
            t = stack.pop(0)
        elif isinstance(stack[0], InputLayer):
            inp = stack.pop(0)
            t = inp.output
        else:
            if input_shape is None:
                raise ValueError("Sequential needs an InputLayer first or "
                                 "input_shape= at compile()")
            t = InputLayer(input_shape).output
        self.inputs = [t]
        for layer in stack:
            t = layer(t)
        self.outputs = [t]
        super().compile(optimizer, loss, metrics, batch_size=batch_size,
                        **kwargs)
