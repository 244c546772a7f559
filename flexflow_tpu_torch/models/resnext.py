"""ResNeXt-50 32x4d.

PyTorch counterpart of ``flexflow_tpu/models/resnext.py`` (after the
original FlexFlow's ``examples/cpp/resnext50/resnext.cc``): a 7x7 stem
and a max pool; stages of (3, 4, 6, 3) blocks, each a 1x1 conv + ReLU, a
grouped 3x3 conv + ReLU (cardinality 32) and a 1x1 conv to twice the
width; an average pool over the whole map, flat, a dense to 1000 classes
and a softmax. Batch 16 at 224 x 224, the OSDI'22 script's. As in the
reference example (whose blocks leave their residual connection off, as
the JAX package's do), no block has a residual connection, and the
network has no BatchNorm.
"""

from __future__ import annotations

import dataclasses

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import ActiMode, PoolType
from flexflow_tpu_torch.model import FFModel


@dataclasses.dataclass
class ResNeXtConfig:
    batch_size: int = 16
    image_size: int = 224
    num_classes: int = 1000
    cardinality: int = 32
    stages: tuple = (3, 4, 6, 3)


def _block(ff: FFModel, t, out_channels: int, stride: int, groups: int,
           name: str):
    t = ff.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0,
                  activation=ActiMode.AC_MODE_RELU, name=f"{name}_c1")
    t = ff.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1,
                  activation=ActiMode.AC_MODE_RELU, groups=groups,
                  name=f"{name}_c2")
    return ff.conv2d(t, 2 * out_channels, 1, 1, 1, 1, 0, 0,
                     name=f"{name}_c3")


def create_resnext50(cfg: ResNeXtConfig, ff_config: FFConfig = None,
                     device=None) -> FFModel:
    """Build the (uncompiled) model on ``device`` (None = the card). Its
    input: ``input``, float ``[B, 3, image_size, image_size]``."""
    ff = FFModel(ff_config or FFConfig(batch_size=cfg.batch_size),
                 device=device)
    t = ff.create_tensor((cfg.batch_size, 3, cfg.image_size, cfg.image_size),
                         name="input")
    t = ff.conv2d(t, 64, 7, 7, 2, 2, 3, 3,
                  activation=ActiMode.AC_MODE_RELU, name="stem")
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1)
    widths = (128, 256, 512, 1024)
    for s, (n_blocks, w) in enumerate(zip(cfg.stages, widths)):
        for i in range(n_blocks):
            stride = 2 if (i == 0 and s > 0) else 1
            t = _block(ff, t, w, stride, cfg.cardinality, f"s{s}_b{i}")
    t = ff.pool2d(t, t.shape[2], t.shape[3], 1, 1, 0, 0,
                  pool_type=PoolType.POOL_AVG)
    t = ff.flat(t)
    t = ff.dense(t, cfg.num_classes, name="fc")
    ff.softmax(t)
    return ff
