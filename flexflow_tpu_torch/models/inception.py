"""Inception-v3.

PyTorch counterpart of ``flexflow_tpu/models/inception.py`` (after the
original FlexFlow's ``examples/cpp/InceptionV3/inception.cc``): the stem
convs and pools; modules A (1x1 / 5x5 / double 3x3 / pool branches), B
(grid reduction), C (7x1 / 1x7 factorized), D (reduction) and E (the
expanded 3x3 / 1x3 / 3x1 splits), their branches concatenated on the
channels; an average pool over the whole map, flat, a dense and a
softmax. Batch 64 at 299 x 299, the OSDI'22 script's. ``reduced=True``
keeps the stem and one module of each family, for small runs. The
network has no BatchNorm and no dropout, as the JAX package builds it.
"""

from __future__ import annotations

import dataclasses

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import ActiMode, PoolType
from flexflow_tpu_torch.model import FFModel

RELU = ActiMode.AC_MODE_RELU


@dataclasses.dataclass
class InceptionConfig:
    batch_size: int = 64
    image_size: int = 299
    num_classes: int = 1000
    # the stem and one module of each family (a/b/c/d/e) only
    reduced: bool = False


def _module_a(ff, x, pool_features, name):
    t1 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, activation=RELU, name=f"{name}_b1")
    t2 = ff.conv2d(x, 48, 1, 1, 1, 1, 0, 0, activation=RELU)
    t2 = ff.conv2d(t2, 64, 5, 5, 1, 1, 2, 2, activation=RELU)
    t3 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0, activation=RELU)
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, activation=RELU)
    t3 = ff.conv2d(t3, 96, 3, 3, 1, 1, 1, 1, activation=RELU)
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type=PoolType.POOL_AVG)
    t4 = ff.conv2d(t4, pool_features, 1, 1, 1, 1, 0, 0, activation=RELU)
    return ff.concat([t1, t2, t3, t4], axis=1)


def _module_b(ff, x, name):
    t1 = ff.conv2d(x, 384, 3, 3, 2, 2, 0, 0)
    t2 = ff.conv2d(x, 64, 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(t2, 96, 3, 3, 1, 1, 1, 1)
    t2 = ff.conv2d(t2, 96, 3, 3, 2, 2, 0, 0)
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([t1, t2, t3], axis=1)


def _module_c(ff, x, channels, name):
    t1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(x, channels, 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(t2, channels, 1, 7, 1, 1, 0, 3)
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0)
    t3 = ff.conv2d(x, channels, 1, 1, 1, 1, 0, 0)
    t3 = ff.conv2d(t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = ff.conv2d(t3, channels, 1, 7, 1, 1, 0, 3)
    t3 = ff.conv2d(t3, channels, 7, 1, 1, 1, 3, 0)
    t3 = ff.conv2d(t3, 192, 1, 7, 1, 1, 0, 3)
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type=PoolType.POOL_AVG)
    t4 = ff.conv2d(t4, 192, 1, 1, 1, 1, 0, 0)
    return ff.concat([t1, t2, t3, t4], axis=1)


def _module_d(ff, x, name):
    t1 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    t1 = ff.conv2d(t1, 320, 3, 3, 2, 2, 0, 0)
    t2 = ff.conv2d(x, 192, 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(t2, 192, 1, 7, 1, 1, 0, 3)
    t2 = ff.conv2d(t2, 192, 7, 1, 1, 1, 3, 0)
    t2 = ff.conv2d(t2, 192, 3, 3, 2, 2, 0, 0)
    t3 = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    return ff.concat([t1, t2, t3], axis=1)


def _module_e(ff, x, name):
    t1 = ff.conv2d(x, 320, 1, 1, 1, 1, 0, 0)
    t2 = ff.conv2d(x, 384, 1, 1, 1, 1, 0, 0)
    t2a = ff.conv2d(t2, 384, 1, 3, 1, 1, 0, 1)
    t2b = ff.conv2d(t2, 384, 3, 1, 1, 1, 1, 0)
    t3 = ff.conv2d(x, 448, 1, 1, 1, 1, 0, 0)
    t3 = ff.conv2d(t3, 384, 3, 3, 1, 1, 1, 1)
    t3a = ff.conv2d(t3, 384, 1, 3, 1, 1, 0, 1)
    t3b = ff.conv2d(t3, 384, 3, 1, 1, 1, 1, 0)
    t4 = ff.pool2d(x, 3, 3, 1, 1, 1, 1, pool_type=PoolType.POOL_AVG)
    t4 = ff.conv2d(t4, 192, 1, 1, 1, 1, 0, 0)
    return ff.concat([t1, t2a, t2b, t3a, t3b, t4], axis=1)


def create_inception_v3(cfg: InceptionConfig, ff_config: FFConfig = None,
                        device=None) -> FFModel:
    """Build the (uncompiled) model on ``device`` (None = the card). Its
    input: ``input``, float ``[B, 3, image_size, image_size]``."""
    ff = FFModel(ff_config or FFConfig(batch_size=cfg.batch_size),
                 device=device)
    x = ff.create_tensor((cfg.batch_size, 3, cfg.image_size, cfg.image_size),
                         name="input")
    x = ff.conv2d(x, 32, 3, 3, 2, 2, 0, 0, activation=RELU)
    x = ff.conv2d(x, 32, 3, 3, 1, 1, 0, 0, activation=RELU)
    x = ff.conv2d(x, 64, 3, 3, 1, 1, 1, 1, activation=RELU)
    x = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    x = ff.conv2d(x, 80, 1, 1, 1, 1, 0, 0, activation=RELU)
    x = ff.conv2d(x, 192, 3, 3, 1, 1, 0, 0, activation=RELU)
    x = ff.pool2d(x, 3, 3, 2, 2, 0, 0)
    x = _module_a(ff, x, 32, "a1")
    if not cfg.reduced:
        x = _module_a(ff, x, 64, "a2")
        x = _module_a(ff, x, 64, "a3")
    x = _module_b(ff, x, "b1")
    x = _module_c(ff, x, 128, "c1")
    if not cfg.reduced:
        x = _module_c(ff, x, 160, "c2")
        x = _module_c(ff, x, 160, "c3")
        x = _module_c(ff, x, 192, "c4")
    x = _module_d(ff, x, "d1")
    x = _module_e(ff, x, "e1")
    if not cfg.reduced:
        x = _module_e(ff, x, "e2")
    x = ff.pool2d(x, x.shape[2], x.shape[3], 1, 1, 0, 0,
                  pool_type=PoolType.POOL_AVG)
    x = ff.flat(x)
    x = ff.dense(x, cfg.num_classes, name="fc")
    ff.softmax(x)
    return ff
