#!/usr/bin/env python
"""MLP example (reference examples/cpp/MLP_Unify), on the PyTorch port:
deep wide MLP — the column/row-parallel showcase.

    python examples_torch/mlp.py -b 64 [--device cpu]
"""

from common import parse_config, train_synthetic

from flexflow_tpu_torch.models import create_mlp


def main(argv=None):
    cfg = parse_config(argv)
    hidden = [4096, 4096, 4096, 4096]
    ff = create_mlp(cfg.batch_size, 1024, hidden, 10, ff_config=cfg,
                    device=cfg._device)
    train_synthetic(ff, cfg, [((1024,), "float32", 0)], (1,), classes=10)


if __name__ == "__main__":
    main()
