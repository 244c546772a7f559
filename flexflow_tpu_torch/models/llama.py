"""Llama-family decoder LM.

PyTorch counterpart of ``flexflow_tpu/models/llama.py``: RMSNorm, rotary
position embeddings, grouped-query attention and SwiGLU MLPs, built from
the framework's own ops. ``import_hf_weights`` loads a HuggingFace
``LlamaForCausalLM``-layout state dict (Mistral's too: the same block).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import DataType
from flexflow_tpu_torch.model import FFModel


@dataclasses.dataclass
class LlamaModelConfig:
    # defaults are a test-size model; Mistral-7B-v0.3 (config.json) is
    # vocab 32768 / hidden 4096 / inter 14336 / 32 layers / 32 heads /
    # 8 kv heads / eps 1e-5 / theta 1e6
    vocab_size: int = 256
    hidden_size: int = 64
    intermediate_size: int = 128
    num_hidden_layers: int = 2
    num_attention_heads: int = 4
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    batch_size: int = 4
    seq_length: int = 16
    seq_parallel: Optional[str] = None  # 'seq' for ring attention


def create_llama(cfg: LlamaModelConfig, ff_config: FFConfig = None,
                 device=None) -> FFModel:
    """Build the (uncompiled) model on ``device`` (None = the card):
    int32 ``input_ids [B, S]`` in, logits ``[B, S, vocab]`` out."""
    ff = FFModel(ff_config or FFConfig(batch_size=cfg.batch_size),
                 device=device)
    ids = ff.create_tensor((cfg.batch_size, cfg.seq_length),
                           dtype=DataType.INT32, name="input_ids")
    t = ff.embedding(ids, cfg.vocab_size, cfg.hidden_size,
                     name="embed_tokens")
    for i in range(cfg.num_hidden_layers):
        # attention sublayer (pre-norm, causal, RoPE, GQA)
        h = ff.rms_norm(t, eps=cfg.rms_norm_eps, name=f"l{i}_input_ln")
        a = ff.multihead_attention(
            h, h, h, cfg.hidden_size, cfg.num_attention_heads,
            bias=False, causal=True,
            num_kv_heads=cfg.num_key_value_heads,
            rope=True, rope_theta=cfg.rope_theta,
            seq_parallel=cfg.seq_parallel,
            name=f"l{i}_attn")
        t = ff.add(t, a, name=f"l{i}_res1")
        # SwiGLU MLP: down(silu(gate(x)) * up(x))
        h = ff.rms_norm(t, eps=cfg.rms_norm_eps, name=f"l{i}_post_ln")
        gate = ff.dense(h, cfg.intermediate_size, use_bias=False,
                        name=f"l{i}_gate_proj")
        up = ff.dense(h, cfg.intermediate_size, use_bias=False,
                      name=f"l{i}_up_proj")
        silu = ff.multiply(gate, ff.sigmoid(gate, name=f"l{i}_sig"),
                           name=f"l{i}_silu")
        h = ff.multiply(silu, up, name=f"l{i}_swiglu")
        h = ff.dense(h, cfg.hidden_size, use_bias=False,
                     name=f"l{i}_down_proj")
        t = ff.add(t, h, name=f"l{i}_res2")
    t = ff.rms_norm(t, eps=cfg.rms_norm_eps, name="final_ln")
    t = ff.dense(t, cfg.vocab_size, use_bias=False, name="lm_head")
    return ff


def import_hf_weights(ff: FFModel, hf_model) -> int:
    """Copy a HuggingFace ``LlamaForCausalLM``-layout model's weights into
    a compiled ``create_llama`` model. ``hf_model`` is any object with
    ``state_dict()`` (tensors or arrays) and ``config`` (HF attribute
    names); without ``lm_head.weight`` the embeddings are tied. Returns
    the number of tensors copied."""
    sd = {k: np.asarray(v.detach().cpu().float() if hasattr(v, "detach")
                        else v)
          for k, v in hf_model.state_dict().items()}
    cfg = hf_model.config
    h = cfg.num_attention_heads
    hk = getattr(cfg, "num_key_value_heads", h)
    e = cfg.hidden_size
    d = e // h

    def heads(w, nh):  # HF [nh*D, E] -> ours [nh, E, D]
        return w.reshape(nh, d, -1).transpose(0, 2, 1)

    copied = 0

    def put(layer, value, pname="kernel"):
        nonlocal copied
        ff.set_parameter(layer, np.ascontiguousarray(value, np.float32),
                         pname)
        copied += 1

    put("embed_tokens", sd["model.embed_tokens.weight"])
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        put(f"l{i}_input_ln", sd[p + "input_layernorm.weight"], "scale")
        put(f"l{i}_attn", heads(sd[p + "self_attn.q_proj.weight"], h), "wq")
        put(f"l{i}_attn", heads(sd[p + "self_attn.k_proj.weight"], hk), "wk")
        put(f"l{i}_attn", heads(sd[p + "self_attn.v_proj.weight"], hk), "wv")
        # o_proj [E, H*D] -> wo [H, D, E]
        put(f"l{i}_attn",
            sd[p + "self_attn.o_proj.weight"].transpose(1, 0).reshape(h, d, e),
            "wo")
        put(f"l{i}_post_ln",
            sd[p + "post_attention_layernorm.weight"], "scale")
        put(f"l{i}_gate_proj", sd[p + "mlp.gate_proj.weight"].T)
        put(f"l{i}_up_proj", sd[p + "mlp.up_proj.weight"].T)
        put(f"l{i}_down_proj", sd[p + "mlp.down_proj.weight"].T)
    put("final_ln", sd["model.norm.weight"], "scale")
    lm = sd.get("lm_head.weight")
    if lm is None:  # tied embeddings
        lm = sd["model.embed_tokens.weight"]
    put("lm_head", lm.T)
    return copied
