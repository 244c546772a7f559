#!/usr/bin/env python
"""Llama-family decoder LM example, on the PyTorch port: RMSNorm + RoPE +
grouped-query attention + SwiGLU, token-level CE.

Run tiny:   python examples_torch/llama_lm.py -b 8 --budget 3 \\
                --enable-parameter-parallel [--device cpu]
Llama-3-8B shapes: --llama3-8b. A compile-scale configuration: 8 B
parameters and their optimizer state do not fit one card, so it is not
run on one (the port's sharded execution is ROADMAP.md Queue 1 item 3).
"""

from common import parse_config, train_synthetic

from flexflow_tpu_torch import LossType
from flexflow_tpu_torch.models import LlamaModelConfig, create_llama


def main(argv=None):
    cfg = parse_config(argv)
    if "--llama3-8b" in cfg._rest:
        mcfg = LlamaModelConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, rope_theta=500000.0,
            batch_size=cfg.batch_size, seq_length=512)
    else:
        mcfg = LlamaModelConfig(vocab_size=512, hidden_size=128,
                                intermediate_size=256, num_hidden_layers=4,
                                num_attention_heads=8, num_key_value_heads=4,
                                batch_size=cfg.batch_size, seq_length=64)
    ff = create_llama(mcfg, cfg, device=cfg._device)
    train_synthetic(
        ff, cfg, [((mcfg.seq_length,), "int32", mcfg.vocab_size)],
        (mcfg.seq_length,), loss=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=(), classes=mcfg.vocab_size)


if __name__ == "__main__":
    main()
