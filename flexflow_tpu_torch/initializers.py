"""Parameter initializers on an explicit ``torch.Generator``.

PyTorch counterpart of ``flexflow_tpu/initializers.py``: the default
weight (Glorot uniform) and bias (zero) initializers. The draws differ
from JAX's PRNG for the same seed: parity with the JAX package goes
through carried weights (``flexflow_tpu_torch.weights``), never through
matching random numbers.
"""

from __future__ import annotations

import math

import torch


class Initializer:
    def __call__(self, generator: torch.Generator, shape,
                 dtype=torch.float32) -> torch.Tensor:
        raise NotImplementedError


class ZeroInitializer(Initializer):
    def __call__(self, generator, shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=generator.device)


class GlorotUniformInitializer(Initializer):
    """Glorot/Xavier uniform over (fan_in, fan_out), fan_in being the
    product of all but the last dim, as the JAX package computes it."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def __call__(self, generator, shape, dtype=torch.float32):
        if len(shape) >= 2:
            fan_out = shape[-1]
            fan_in = math.prod(shape[:-1])
        else:
            fan_in = fan_out = shape[0] if shape else 1
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        out = torch.empty(shape, dtype=dtype, device=generator.device)
        return out.uniform_(-limit, limit, generator=generator)


DefaultWeightInitializer = GlorotUniformInitializer
DefaultBiasInitializer = ZeroInitializer
