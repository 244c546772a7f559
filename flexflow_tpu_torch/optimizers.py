"""Optimizers: SGD (+momentum/nesterov) and Adam.

PyTorch counterpart of ``flexflow_tpu/optimizers.py``: the same
functional shape — ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state)`` — over the
port's ``{op name: {param name: tensor}}`` trees, and the same math in
the same operand order, so a step of the port and a step of the JAX
package agree to the last bit wherever their elementwise ops round alike.
The per-leaf math is ``_adam_math`` / ``_sgd_math`` of
``ops/fused_update.py``, the one expression that the fused path and the
Adam kernel's plain version also run. ``update`` is functional (it
returns new tensors and leaves its inputs as they were); the fused
``_k:fused`` path is the one that updates in place.

The state follows the parameter tree it is made from: under
weight-update sharding each rank's parameters are its master shards
(``executor.py``), so ``init`` makes its moments at those shards and
``update`` runs on them.

Adam's step count ``t`` is an int32 device tensor and its bias-corrected
``alpha_t`` is computed from it in f32 on the device, exactly as the JAX
package computes it, so a step neither rounds through Python doubles nor
syncs with the host.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from flexflow_tpu_torch.ffconst import ParameterSyncType
from flexflow_tpu_torch.ops.fused_update import _adam_math, _sgd_math


def _map(fn, *trees):
    """``fn`` over matching leaves of ``{op: {param: tensor}}`` trees."""
    return {op: {pn: fn(*(t[op][pn] for t in trees)) for pn in sub}
            for op, sub in trees[0].items()}


class Optimizer:
    parameter_sync = ParameterSyncType.NCCL

    def init(self, params) -> Any:
        raise NotImplementedError

    def update(self, grads, state, params) -> Tuple[Any, Any]:
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    """lr, momentum, nesterov, weight_decay."""

    def __init__(self, ffmodel=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def init(self, params):
        if self.momentum == 0.0:
            return {}
        return {"v": _map(torch.zeros_like, params)}

    def update(self, grads, state, params):
        wd = self.weight_decay

        if self.momentum == 0.0:
            return _map(lambda p, g: p - self.lr * (g + wd * p),
                        params, grads), state

        pairs = _map(lambda p, g, v: _sgd_math(self, p, g, v), params, grads,
                     state["v"])
        return (_map(lambda x: x[0], pairs),
                {"v": _map(lambda x: x[1], pairs)})


class AdamOptimizer(Optimizer):
    """alpha/beta1/beta2/epsilon/weight_decay with the bias-corrected
    alpha_t of each step; ``state_dtype`` (e.g. ``torch.bfloat16``) stores
    m and v in a narrower dtype while the math stays in the parameter
    dtype (cast in, cast out). None keeps the parameter dtype."""

    def __init__(self, ffmodel=None, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8, state_dtype=None):
        self.alpha = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon
        self.state_dtype = state_dtype

    def _state_like(self, p):
        return torch.zeros_like(p, dtype=self.state_dtype or p.dtype)

    def init(self, params):
        dev = next((t.device for sub in params.values() for t in sub.values()),
                   torch.device("cpu"))
        return {
            "m": _map(self._state_like, params),
            "v": _map(self._state_like, params),
            "t": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def step_scalars(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t + 1, alpha_t) as device tensors: alpha_t = alpha *
        sqrt(1 - beta2^t) / (1 - beta1^t), every operation in f32."""
        t = t + 1
        tf = t.to(torch.float32)
        bc = torch.sqrt(1.0 - self.beta2 ** tf) / (1.0 - self.beta1 ** tf)
        return t, self.alpha * bc

    def update(self, grads, state, params):
        t, alpha_t = self.step_scalars(state["t"])
        trip = _map(lambda p, g, m, v: _adam_math(
            p, g, m, v, alpha_t, beta1=self.beta1, beta2=self.beta2,
            eps=self.epsilon, wd=self.weight_decay),
            params, grads, state["m"], state["v"])
        return (_map(lambda x: x[0], trip),
                {"m": _map(lambda x: x[1], trip),
                 "v": _map(lambda x: x[2], trip), "t": t})
