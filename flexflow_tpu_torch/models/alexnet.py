"""AlexNet.

PyTorch counterpart of ``flexflow_tpu/models/alexnet.py`` (after the
original FlexFlow's ``examples/cpp/AlexNet/alexnet.cc``): five convs
with ReLU (11x11/4, 5x5, three 3x3) and three 3x3/2 max pools, flat,
fc6 and fc7 of 4096 with ReLU, each followed by a dropout at 0.5, fc8
and a softmax. ``batch_norm=True`` swaps each conv's ReLU for a
conv -> BatchNorm(+ReLU) pair, the modern AlexNet-BN.
"""

from __future__ import annotations

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import ActiMode
from flexflow_tpu_torch.model import FFModel


def create_alexnet(batch_size: int = 64, num_classes: int = 10,
                   image_size: int = 224, batch_norm: bool = False,
                   ff_config: FFConfig = None, device=None) -> FFModel:
    """Build the (uncompiled) model on ``device`` (None = the card). Its
    input: float ``[batch_size, 3, image_size, image_size]``."""
    ff = FFModel(ff_config or FFConfig(batch_size=batch_size), device=device)

    def conv(t, ch, k, s, p, name):
        if batch_norm:
            t = ff.conv2d(t, ch, k, k, s, s, p, p, name=name)
            return ff.batch_norm(t, relu=True, name=f"{name}_bn")
        return ff.conv2d(t, ch, k, k, s, s, p, p,
                         activation=ActiMode.AC_MODE_RELU, name=name)

    t = ff.create_tensor((batch_size, 3, image_size, image_size))
    t = conv(t, 64, 11, 4, 2, "conv1")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = conv(t, 192, 5, 1, 2, "conv2")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = conv(t, 384, 3, 1, 1, "conv3")
    t = conv(t, 256, 3, 1, 1, "conv4")
    t = conv(t, 256, 3, 1, 1, "conv5")
    t = ff.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = ff.flat(t)
    t = ff.dense(t, 4096, activation=ActiMode.AC_MODE_RELU, name="fc6")
    t = ff.dropout(t, 0.5)
    t = ff.dense(t, 4096, activation=ActiMode.AC_MODE_RELU, name="fc7")
    t = ff.dropout(t, 0.5)
    t = ff.dense(t, num_classes, name="fc8")
    ff.softmax(t)
    return ff
