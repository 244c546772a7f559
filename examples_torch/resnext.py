#!/usr/bin/env python
"""ResNeXt-50 example (reference examples/cpp/resnext50), on the PyTorch
port.

    python examples_torch/resnext.py [-b 16] [--device cpu]
"""

from common import parse_config, train_synthetic

from flexflow_tpu_torch.models import ResNeXtConfig, create_resnext50


def main(argv=None):
    cfg = parse_config(argv)
    rc = ResNeXtConfig(
        batch_size=cfg.batch_size if cfg.batch_size_explicit else 16)
    cfg.batch_size = rc.batch_size
    ff = create_resnext50(rc, cfg, device=cfg._device)
    train_synthetic(ff, cfg, [((3, rc.image_size, rc.image_size), "float32", 0)],
                    (1,), classes=rc.num_classes)


if __name__ == "__main__":
    main()
