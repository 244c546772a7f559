"""Mixture-of-Experts models (the original FlexFlow's
examples/cpp/mixture_of_experts/moe.cc).

PyTorch counterpart of ``flexflow_tpu/models/moe_model.py``: the flat MoE
classifier (flattened input -> an MoE layer of ``num_exp`` experts, top-k
selection and the load-balance loss -> a softmax head) and the encoder
variant, which stacks attention and MoE blocks with a token-level MoE.
"""

from __future__ import annotations

import dataclasses

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.model import FFModel


@dataclasses.dataclass
class MoEConfig:
    batch_size: int = 32
    input_dim: int = 784  # the reference's MNIST-shaped input
    num_classes: int = 10
    num_exp: int = 4
    num_select: int = 2
    hidden_size: int = 64
    alpha: float = 2.0      # group_by capacity factor
    lambda_bal: float = 0.04  # load-balance loss weight
    # encoder variant
    num_encoder_layers: int = 0
    seq_length: int = 16
    num_attention_heads: int = 4


def create_moe(cfg: MoEConfig, ff_config: FFConfig = None,
               device=None, fused: bool = True) -> FFModel:
    """Flat MoE classifier on ``device`` (None = the card); ``fused=False``
    builds the MoE layer as the reference's literal subgraph."""
    ff = FFModel(ff_config or FFConfig(batch_size=cfg.batch_size),
                 device=device)
    t = ff.create_tensor((cfg.batch_size, cfg.input_dim), name="input")
    t = ff.moe(t, cfg.num_exp, cfg.num_select, cfg.hidden_size,
               cfg.alpha, cfg.lambda_bal, fused=fused, name="moe")
    t = ff.dense(t, cfg.num_classes, name="head")
    t = ff.softmax(t)
    return ff


def create_moe_encoder(cfg: MoEConfig, ff_config: FFConfig = None,
                       device=None) -> FFModel:
    """Attention + MoE encoder stack on ``device`` (None = the card): each
    block is LN(x + attention(x)) then LN(x + moe(x)), the MoE over the
    flattened tokens ``[B*S, H]``."""
    ff = FFModel(ff_config or FFConfig(batch_size=cfg.batch_size),
                 device=device)
    x = ff.create_tensor((cfg.batch_size, cfg.seq_length, cfg.hidden_size),
                         name="input")
    for i in range(max(cfg.num_encoder_layers, 1)):
        a = ff.multihead_attention(x, x, x, cfg.hidden_size,
                                   cfg.num_attention_heads, name=f"attn_{i}")
        x = ff.layer_norm(ff.add(x, a, name=f"res1_{i}"), name=f"ln1_{i}")
        # token-level MoE: flatten tokens into the sample dim
        b, s, h = x.shape
        flat = ff.reshape(x, (b * s, h), name=f"flatten_{i}")
        m = ff.moe(flat, cfg.num_exp, cfg.num_select, cfg.hidden_size,
                   cfg.alpha, cfg.lambda_bal, name=f"moe_{i}")
        m = ff.reshape(m, (b, s, h), name=f"unflatten_{i}")
        x = ff.layer_norm(ff.add(x, m, name=f"res2_{i}"), name=f"ln2_{i}")
    x = ff.dense(x, cfg.num_classes, name="head")
    x = ff.softmax(x)
    return ff
