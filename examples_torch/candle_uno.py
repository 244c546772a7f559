#!/usr/bin/env python
"""CANDLE-Uno example (reference examples/cpp/candle_uno), on the PyTorch
port.

    python examples_torch/candle_uno.py -b 64 [--device cpu]
"""

from common import parse_config, train_synthetic

from flexflow_tpu_torch import LossType, MetricsType
from flexflow_tpu_torch.models import CandleUnoConfig, create_candle_uno


def main(argv=None):
    cfg = parse_config(argv)
    cc = CandleUnoConfig(batch_size=cfg.batch_size)
    ff = create_candle_uno(cc, cfg, device=cfg._device)
    specs = [((d,), "float32", 0) for d in cc.input_features.values()]
    train_synthetic(ff, cfg, specs, (1,),
                    loss=LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                    metrics=(MetricsType.MEAN_SQUARED_ERROR,))


if __name__ == "__main__":
    main()
