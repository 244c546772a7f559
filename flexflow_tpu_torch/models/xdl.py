"""XDL click-through model.

PyTorch counterpart of ``flexflow_tpu/models/xdl.py`` (after the
original FlexFlow's ``examples/cpp/XDL/xdl.cc``), with its default
configuration: batch 64, 4 tables of 1,000,000 x 64 looked up one id a
feature (SUM aggregated), concatenated and fed to the MLP 512-256-128-2
ending in a binary softmax.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType
from flexflow_tpu_torch.model import FFModel


@dataclasses.dataclass
class XDLConfig:
    batch_size: int = 64
    embedding_size: Sequence[int] = (1000000,) * 4
    sparse_feature_size: int = 64
    embedding_bag_size: int = 1
    mlp: Sequence[int] = (512, 256, 128, 2)


def create_xdl(cfg: XDLConfig, ff_config: FFConfig = None,
               device=None) -> FFModel:
    """Build the (uncompiled) model on ``device`` (None = the card). Its
    inputs: ``sparse_0..`` int32 ``[B, embedding_bag_size]`` ids."""
    ff = FFModel(ff_config or FFConfig(batch_size=cfg.batch_size),
                 device=device)
    embedded = []
    for i, vocab in enumerate(cfg.embedding_size):
        ids = ff.create_tensor((cfg.batch_size, cfg.embedding_bag_size),
                               dtype=DataType.INT32, name=f"sparse_{i}")
        embedded.append(ff.embedding(ids, vocab, cfg.sparse_feature_size,
                                     aggr=AggrMode.AGGR_MODE_SUM,
                                     name=f"emb_{i}"))
    t = ff.concat(embedded, axis=-1, name="concat_emb")
    for j, width in enumerate(cfg.mlp[:-1]):
        t = ff.dense(t, width, activation=ActiMode.AC_MODE_RELU,
                     name=f"mlp_d{j}")
    t = ff.dense(t, cfg.mlp[-1], name="mlp_out")
    ff.softmax(t)
    return ff
