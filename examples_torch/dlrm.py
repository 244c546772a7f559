#!/usr/bin/env python
"""DLRM example (reference examples/cpp/DLRM), on the PyTorch port:
embedding tables + bottom/top MLPs.

    python examples_torch/dlrm.py -b 64 [--device cpu]
"""

from common import parse_config, train_synthetic

from flexflow_tpu_torch import LossType, MetricsType
from flexflow_tpu_torch.models import DLRMConfig, create_dlrm
from flexflow_tpu_torch.optimizers import SGDOptimizer


def main(argv=None):
    cfg = parse_config(argv)
    dc = DLRMConfig(batch_size=cfg.batch_size)
    ff = create_dlrm(dc, cfg, device=cfg._device)
    specs = [((dc.indices_per_feature,), "int32", dc.vocab_size)
             for _ in range(dc.num_sparse_features)]
    specs.append(((dc.dense_dim,), "float32", 0))
    train_synthetic(ff, cfg, specs, (1,),
                    loss=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                    metrics=(MetricsType.MEAN_SQUARED_ERROR,),
                    optimizer=SGDOptimizer(lr=0.01))


if __name__ == "__main__":
    main()
