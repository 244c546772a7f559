#!/usr/bin/env python
"""Mixture-of-Experts example (reference examples/cpp/mixture_of_experts),
on the PyTorch port: the flat MoE classifier, its experts one fused op,
trained with the load-balance loss in the objective.

    python examples_torch/moe.py -b 32 [--device cpu]
"""

from common import parse_config, train_synthetic

from flexflow_tpu_torch.models import MoEConfig, create_moe
from flexflow_tpu_torch.optimizers import AdamOptimizer


def main(argv=None):
    cfg = parse_config(argv)
    mc = MoEConfig(batch_size=cfg.batch_size)
    ff = create_moe(mc, cfg, device=cfg._device)
    train_synthetic(ff, cfg, [((mc.input_dim,), "float32", 0)], (1,),
                    classes=mc.num_classes,
                    optimizer=AdamOptimizer(alpha=1e-3))


if __name__ == "__main__":
    main()
