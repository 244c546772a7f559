"""Keras-style optimizer wrappers over the port's optimizers."""

from __future__ import annotations

from flexflow_tpu_torch import optimizers as ff


class SGD:
    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def to_ff(self) -> ff.Optimizer:
        return ff.SGDOptimizer(lr=self.learning_rate, momentum=self.momentum,
                               nesterov=self.nesterov,
                               weight_decay=self.weight_decay)


class Adam:
    def __init__(self, learning_rate: float = 0.001, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def to_ff(self) -> ff.Optimizer:
        return ff.AdamOptimizer(alpha=self.learning_rate, beta1=self.beta_1,
                                beta2=self.beta_2, epsilon=self.epsilon,
                                weight_decay=self.weight_decay)
