"""Minimal keras.backend shim (the port's copy of
``flexflow_tpu/keras/backend.py``)."""

from __future__ import annotations

import numpy as np

_IMAGE_DATA_FORMAT = "channels_first"  # the Keras frontend is NCHW


def image_data_format() -> str:
    return _IMAGE_DATA_FORMAT


def set_image_data_format(fmt: str) -> None:
    global _IMAGE_DATA_FORMAT
    if fmt not in ("channels_first", "channels_last"):
        raise ValueError(fmt)
    _IMAGE_DATA_FORMAT = fmt


def to_categorical(y, num_classes: int) -> np.ndarray:
    y = np.asarray(y, dtype=np.int64).reshape(-1)
    out = np.zeros((y.shape[0], num_classes), dtype=np.float32)
    out[np.arange(y.shape[0]), y] = 1.0
    return out
