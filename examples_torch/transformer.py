#!/usr/bin/env python
"""BERT-proxy Transformer example (reference examples/cpp/Transformer), on
the PyTorch port.

Reference config: 12 layers, hidden 1024, 16 heads, seq 512, batch 8
(transformer.cc:79-84). Usage:
    python examples_torch/transformer.py --budget 30 [-b 8] [--epochs 1]
    python examples_torch/transformer.py --only-data-parallel
    python examples_torch/transformer.py --lint error \\
        --import-strategy STRATEGY.json
On the card the attention ops run the flash kernels, and a strategy
file with ``_k:fused`` choices routes Adam through the fused kernel.
"""

from common import parse_config, train_synthetic

from flexflow_tpu_torch import LossType, MetricsType
from flexflow_tpu_torch.models import TransformerConfig, create_transformer
from flexflow_tpu_torch.optimizers import AdamOptimizer


def main(argv=None):
    cfg = parse_config(argv)
    tc = TransformerConfig(
        batch_size=cfg.batch_size if cfg.batch_size_explicit else 8)
    cfg.batch_size = tc.batch_size
    ff = create_transformer(tc, cfg, device=cfg._device)
    train_synthetic(
        ff, cfg,
        [((tc.seq_length, tc.hidden_size), "float32", 0)],
        (tc.seq_length, 1),
        loss=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
        metrics=(MetricsType.MEAN_SQUARED_ERROR,),
        optimizer=AdamOptimizer(alpha=1e-4),
    )


if __name__ == "__main__":
    main()
