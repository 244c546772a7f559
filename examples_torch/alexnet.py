#!/usr/bin/env python
"""AlexNet example (reference examples/cpp/AlexNet), on the PyTorch port.

    python examples_torch/alexnet.py -b 64 [--device cpu]
"""

from common import parse_config, train_synthetic

from flexflow_tpu_torch.models import create_alexnet


def main(argv=None):
    cfg = parse_config(argv)
    ff = create_alexnet(cfg.batch_size, ff_config=cfg, device=cfg._device)
    shape = ff.input_tensors[0].shape[1:]
    train_synthetic(ff, cfg, [(shape, "float32", 0)], (1,), classes=10)


if __name__ == "__main__":
    main()
