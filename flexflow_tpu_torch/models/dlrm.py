"""DLRM: sparse embedding tables, bottom and top MLPs, and the concat
feature interaction.

PyTorch counterpart of ``flexflow_tpu/models/dlrm.py`` (after the
original FlexFlow's ``examples/cpp/DLRM/dlrm.cc``), with its default
configuration: batch 64, 8 tables of 100,000 x 64 (one id a feature, SUM
aggregated), a 16-wide dense input through the bottom MLP 512-256-64,
concatenated with the embeddings (``interact_features``' "cat" mode) into
the top MLP 512-256-1 and a sigmoid.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType
from flexflow_tpu_torch.model import FFModel


@dataclasses.dataclass
class DLRMConfig:
    batch_size: int = 64
    num_sparse_features: int = 8
    vocab_size: int = 100000
    embedding_dim: int = 64
    indices_per_feature: int = 1
    dense_dim: int = 16
    bottom_mlp: Sequence[int] = (512, 256, 64)
    top_mlp: Sequence[int] = (512, 256, 1)


def create_dlrm(cfg: DLRMConfig, ff_config: FFConfig = None,
                device=None) -> FFModel:
    """Build the (uncompiled) model on ``device`` (None = the card). Its
    inputs: ``sparse_0..`` int32 ``[B, indices_per_feature]`` ids, then
    ``dense`` float ``[B, dense_dim]``."""
    ff = FFModel(ff_config or FFConfig(batch_size=cfg.batch_size),
                 device=device)
    sparse_outs = []
    for i in range(cfg.num_sparse_features):
        ids = ff.create_tensor(
            (cfg.batch_size, cfg.indices_per_feature), DataType.INT32,
            name=f"sparse_{i}")
        sparse_outs.append(ff.embedding(ids, cfg.vocab_size,
                                        cfg.embedding_dim,
                                        aggr=AggrMode.AGGR_MODE_SUM,
                                        name=f"emb_{i}"))
    t = ff.create_tensor((cfg.batch_size, cfg.dense_dim), name="dense")
    for j, h in enumerate(cfg.bottom_mlp):
        t = ff.dense(t, h, activation=ActiMode.AC_MODE_RELU, name=f"bot_{j}")
    z = ff.concat(sparse_outs + [t], axis=1, name="interact")
    for j, h in enumerate(cfg.top_mlp):
        act = (ActiMode.AC_MODE_RELU if j < len(cfg.top_mlp) - 1
               else ActiMode.AC_MODE_SIGMOID)
        z = ff.dense(z, h, activation=act, name=f"top_{j}")
    return ff
