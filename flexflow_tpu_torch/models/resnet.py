"""ResNet-50.

PyTorch counterpart of ``flexflow_tpu/models/resnet.py`` (after the
original FlexFlow's ``examples/cpp/ResNet/resnet.cc``): a 7x7/2 stem and
a 3x3/2 max pool; stages of (3, 4, 6, 3) bottlenecks, each a 1x1 conv, a
3x3 conv (the stage's stride on its first block) and a 1x1 conv to four
times the width, a projection shortcut where the stride or the width
changes, and a ReLU after the join; an average pool over the whole map,
flat, a dense to 10 classes (the reference's head) and a softmax.
``batch_norm=True`` is the textbook ResNet, conv -> BatchNorm everywhere
(53 pairs at the default stages), the zoo's Conv+BN fold path; the
reference example has no BatchNorm, and neither has the default.
"""

from __future__ import annotations

import dataclasses

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import ActiMode, PoolType
from flexflow_tpu_torch.model import FFModel


@dataclasses.dataclass
class ResNetConfig:
    batch_size: int = 64
    image_size: int = 224
    num_classes: int = 10
    stages: tuple = (3, 4, 6, 3)
    batch_norm: bool = False


def _conv_bn(ff: FFModel, t, out_channels: int, kh: int, kw: int,
             stride: int, pad: int, name: str, bn: bool, relu: bool):
    if bn:
        t = ff.conv2d(t, out_channels, kh, kw, stride, stride, pad, pad,
                      name=name)
        return ff.batch_norm(t, relu=relu, name=f"{name}_bn")
    return ff.conv2d(t, out_channels, kh, kw, stride, stride, pad, pad,
                     activation=ActiMode.AC_MODE_RELU if relu
                     else ActiMode.AC_MODE_NONE, name=name)


def _bottleneck(ff: FFModel, t, out_channels: int, stride: int, name: str,
                bn: bool = False):
    inp = t
    t = _conv_bn(ff, t, out_channels, 1, 1, 1, 0, f"{name}_c1", bn, False)
    t = ff.relu(t)
    t = _conv_bn(ff, t, out_channels, 3, 3, stride, 1, f"{name}_c2", bn,
                 False)
    t = ff.relu(t)
    t = _conv_bn(ff, t, 4 * out_channels, 1, 1, 1, 0, f"{name}_c3", bn,
                 False)
    if stride > 1 or inp.shape[1] != 4 * out_channels:
        # the projection shortcut has no activation
        inp = _conv_bn(ff, inp, 4 * out_channels, 1, 1, stride, 0,
                       f"{name}_proj", bn, False)
    t = ff.add(t, inp, name=f"{name}_add")
    return ff.relu(t, inplace=False)


def create_resnet(cfg: ResNetConfig, ff_config: FFConfig = None,
                  device=None) -> FFModel:
    """Build the (uncompiled) model on ``device`` (None = the card). Its
    input: ``input``, float ``[B, 3, image_size, image_size]``."""
    ff = FFModel(ff_config or FFConfig(batch_size=cfg.batch_size),
                 device=device)
    bn = cfg.batch_norm
    t = ff.create_tensor((cfg.batch_size, 3, cfg.image_size, cfg.image_size),
                         name="input")
    t = _conv_bn(ff, t, 64, 7, 7, 2, 3, "stem", bn, bn)
    t = ff.pool2d(t, 3, 3, 2, 2, 1, 1)
    for s, width in enumerate((64, 128, 256, 512)):
        for i in range(cfg.stages[s]):
            t = _bottleneck(ff, t, width, 2 if (i == 0 and s > 0) else 1,
                            f"s{s + 1}_b{i}", bn)
    t = ff.pool2d(t, t.shape[2], t.shape[3], 1, 1, 0, 0,
                  pool_type=PoolType.POOL_AVG)
    t = ff.flat(t)
    t = ff.dense(t, cfg.num_classes, name="fc")
    ff.softmax(t)
    return ff
