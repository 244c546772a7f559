#!/usr/bin/env python
"""Inception-v3 example (reference examples/cpp/InceptionV3), on the
PyTorch port.

    python examples_torch/inception.py -b 64 [--device cpu]
"""

from common import parse_config, train_synthetic

from flexflow_tpu_torch.models import InceptionConfig, create_inception_v3


def main(argv=None):
    cfg = parse_config(argv)
    ic = InceptionConfig(batch_size=cfg.batch_size)
    ff = create_inception_v3(ic, cfg, device=cfg._device)
    train_synthetic(ff, cfg, [((3, ic.image_size, ic.image_size), "float32", 0)],
                    (1,), classes=ic.num_classes)


if __name__ == "__main__":
    main()
