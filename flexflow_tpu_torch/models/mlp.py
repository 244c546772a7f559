"""MLP model: stacked dense layers and a softmax head.

PyTorch counterpart of ``flexflow_tpu/models/mlp.py`` (after the original
FlexFlow's ``examples/cpp/MLP_Unify/mlp.cc``).
"""

from __future__ import annotations

from typing import Sequence

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import ActiMode
from flexflow_tpu_torch.model import FFModel


def create_mlp(batch_size: int = 64, in_dim: int = 1024,
               hidden_dims: Sequence[int] = (4096, 4096, 4096),
               out_dim: int = 10, ff_config: FFConfig = None,
               device=None) -> FFModel:
    """Build the (uncompiled) model on ``device`` (None = the card)."""
    ff = FFModel(ff_config or FFConfig(batch_size=batch_size), device=device)
    t = ff.create_tensor((batch_size, in_dim))
    for i, h in enumerate(hidden_dims):
        t = ff.dense(t, h, activation=ActiMode.AC_MODE_RELU, name=f"mlp_{i}")
    t = ff.dense(t, out_dim, name="mlp_out")
    t = ff.softmax(t)
    return ff
