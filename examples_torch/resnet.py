#!/usr/bin/env python
"""ResNet-50 example (reference examples/cpp/ResNet), on the PyTorch port.

    python examples_torch/resnet.py -b 64 [--device cpu]
"""

from common import parse_config, train_synthetic

from flexflow_tpu_torch.models import ResNetConfig, create_resnet


def main(argv=None):
    cfg = parse_config(argv)
    rc = ResNetConfig(batch_size=cfg.batch_size)
    ff = create_resnet(rc, cfg, device=cfg._device)
    train_synthetic(ff, cfg, [((3, rc.image_size, rc.image_size), "float32", 0)],
                    (1,), classes=rc.num_classes)


if __name__ == "__main__":
    main()
