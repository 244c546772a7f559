"""Transformer / BERT-proxy model.

PyTorch counterpart of ``flexflow_tpu/models/transformer.py``: the OSDI'22
Unity BERT benchmark configuration (12 layers, hidden 1024, 16 heads, seq
512, batch 8) as a pre-LN encoder; each layer = MHA + residual + 2-layer
FFN, and a dense head to 1 output per position.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import ActiMode, LossType, MetricsType
from flexflow_tpu_torch.model import FFModel


@dataclasses.dataclass
class TransformerConfig:
    num_layers: int = 12
    hidden_size: int = 1024
    num_heads: int = 16
    seq_length: int = 512
    batch_size: int = 8
    ffn_mult: int = 4
    dropout: float = 0.0
    layer_norm: bool = True  # False = exact reference block structure
    causal: bool = False
    seq_parallel: Optional[str] = None  # ring attention's mesh axis ("seq")


def create_transformer(cfg: TransformerConfig, ff_config: FFConfig = None,
                       device=None) -> FFModel:
    """Build the (uncompiled) model on ``device`` (None = the card)."""
    ff = FFModel(ff_config or FFConfig(batch_size=cfg.batch_size),
                 device=device)
    t = ff.create_tensor((cfg.batch_size, cfg.seq_length, cfg.hidden_size),
                         name="input")
    for i in range(cfg.num_layers):
        a_in = ff.layer_norm(t, name=f"ln1_{i}") if cfg.layer_norm else t
        a = ff.multihead_attention(
            a_in, a_in, a_in, cfg.hidden_size, cfg.num_heads,
            dropout=cfg.dropout, causal=cfg.causal,
            seq_parallel=cfg.seq_parallel, name=f"attn_{i}")
        t = ff.add(t, a, name=f"res1_{i}")
        f_in = ff.layer_norm(t, name=f"ln2_{i}") if cfg.layer_norm else t
        h = ff.dense(f_in, cfg.hidden_size * cfg.ffn_mult,
                     activation=ActiMode.AC_MODE_RELU, name=f"ffn1_{i}")
        h = ff.dense(h, cfg.hidden_size, name=f"ffn2_{i}")
        t = ff.add(t, h, name=f"res2_{i}")
    t = ff.dense(t, 1, name="head")
    return ff


def compile_transformer(cfg: TransformerConfig, ff_config: FFConfig = None,
                        optimizer=None, mesh=None, device=None) -> FFModel:
    """Build and compile for training (SGD lr 0.01 unless ``optimizer``,
    MSE loss) on ``device`` (None = the card), over ``mesh``
    (``machine.make_mesh``; a ``{"seq": n}`` mesh runs ``seq_parallel``
    attention as a ring of n positions on the one device)."""
    from flexflow_tpu_torch.optimizers import SGDOptimizer

    ff = create_transformer(cfg, ff_config, device=device)
    ff.compile(optimizer or SGDOptimizer(lr=0.01),
               LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [MetricsType.MEAN_SQUARED_ERROR], mesh=mesh)
    return ff
