"""Keras-style callbacks (the port's copy of
``flexflow_tpu/keras/callbacks.py``).

``on_epoch_end`` returning False stops training: ``Model.fit`` ends
after that epoch (EarlyStopping)."""

from __future__ import annotations

from typing import Dict, Optional


class Callback:
    def set_model(self, model):
        self.model = model

    def on_train_begin(self):
        pass

    def on_train_end(self):
        pass

    def on_epoch_begin(self, epoch: int):
        pass

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None):
        pass


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "loss", min_delta: float = 0.0,
                 patience: int = 0, mode: str = "min"):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.wait = 0

    def on_train_begin(self):
        self.best = None
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        if not logs or self.monitor not in logs:
            return None
        cur = logs[self.monitor]
        improved = (
            self.best is None
            or (self.mode == "min" and cur < self.best - self.min_delta)
            or (self.mode == "max" and cur > self.best + self.min_delta)
        )
        if improved:
            self.best = cur
            self.wait = 0
            return None
        self.wait += 1
        if self.wait > self.patience:
            return False
        return None


class History(Callback):
    def on_train_begin(self):
        self.history: Dict[str, list] = {}

    def on_epoch_end(self, epoch, logs=None):
        for k, v in (logs or {}).items():
            self.history.setdefault(k, []).append(v)


class LambdaCallback(Callback):
    def __init__(self, on_epoch_end=None, on_train_begin=None,
                 on_train_end=None):
        self._on_epoch_end = on_epoch_end
        self._on_train_begin = on_train_begin
        self._on_train_end = on_train_end

    def on_train_begin(self):
        if self._on_train_begin:
            self._on_train_begin()

    def on_train_end(self):
        if self._on_train_end:
            self._on_train_end()

    def on_epoch_end(self, epoch, logs=None):
        if self._on_epoch_end:
            return self._on_epoch_end(epoch, logs)
