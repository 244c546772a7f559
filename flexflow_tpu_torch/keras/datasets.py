"""Dataset loaders (the port's copy of ``flexflow_tpu/keras/datasets.py``).

Nothing is downloaded. Each loader reads a local copy only where
``$FLEXFLOW_TPU_DATA`` names a directory holding it (mnist.npz /
cifar10.npz / reuters.npz with the standard keras key layout), and
otherwise makes a deterministic synthetic stand-in from a fixed seed,
with the same shapes, dtypes and generator as the JAX package's, so both
packages load the same arrays.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _synthetic_classification(n, shape, num_classes, seed):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, num_classes, n).astype(np.int64)
    protos = rs.randn(num_classes, *shape).astype(np.float32) * 2
    x = protos[y] + rs.randn(n, *shape).astype(np.float32)
    x = ((x - x.min()) / (x.max() - x.min()) * 255).astype(np.uint8)
    return x, y


def _load_npz(name: str, keys=("x_train", "y_train", "x_test", "y_test")):
    data_dir = os.environ.get("FLEXFLOW_TPU_DATA")
    if not data_dir:
        return None
    path = os.path.join(data_dir, name)
    if os.path.exists(path):
        d = np.load(path)
        return tuple(d[k] for k in keys)
    return None


class mnist:
    @staticmethod
    def load_data() -> Tuple[Tuple[np.ndarray, np.ndarray],
                             Tuple[np.ndarray, np.ndarray]]:
        cached = _load_npz("mnist.npz")
        if cached is not None:
            x_tr, y_tr, x_te, y_te = cached
        else:
            x_tr, y_tr = _synthetic_classification(8192, (28, 28), 10, 0)
            x_te, y_te = _synthetic_classification(1024, (28, 28), 10, 1)
        return (x_tr, y_tr), (x_te, y_te)


class cifar10:
    @staticmethod
    def load_data():
        cached = _load_npz("cifar10.npz")
        if cached is not None:
            x_tr, y_tr, x_te, y_te = cached
        else:
            x_tr, y_tr = _synthetic_classification(8192, (32, 32, 3), 10, 2)
            x_te, y_te = _synthetic_classification(1024, (32, 32, 3), 10, 3)
            y_tr = y_tr.reshape(-1, 1)
            y_te = y_te.reshape(-1, 1)
        return (x_tr, y_tr), (x_te, y_te)


class reuters:
    @staticmethod
    def load_data(num_words: int = 10000, maxlen: int = 200):
        cached = _load_npz("reuters.npz")
        if cached is not None:
            x_tr, y_tr, x_te, y_te = cached
            return (x_tr, y_tr), (x_te, y_te)
        rs = np.random.RandomState(4)
        n_tr, n_te, classes = 2048, 512, 46
        x_tr = rs.randint(1, num_words, (n_tr, maxlen)).astype(np.int32)
        x_te = rs.randint(1, num_words, (n_te, maxlen)).astype(np.int32)
        y_tr = rs.randint(0, classes, n_tr).astype(np.int64)
        y_te = rs.randint(0, classes, n_te).astype(np.int64)
        return (x_tr, y_tr), (x_te, y_te)
