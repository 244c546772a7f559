#!/usr/bin/env python
"""XDL example (reference examples/cpp/XDL), on the PyTorch port.

    python examples_torch/xdl.py -b 64 [--device cpu]
"""

from common import parse_config, train_synthetic

from flexflow_tpu_torch.models import XDLConfig, create_xdl


def main(argv=None):
    cfg = parse_config(argv)
    xc = XDLConfig(batch_size=cfg.batch_size)
    ff = create_xdl(xc, cfg, device=cfg._device)
    specs = [((xc.embedding_bag_size,), "int32", v) for v in xc.embedding_size]
    train_synthetic(ff, cfg, specs, (1,), classes=2)


if __name__ == "__main__":
    main()
