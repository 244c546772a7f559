"""Keras-compatible frontend: the port's counterpart of ``flexflow_tpu/keras``.

Usage mirrors tf.keras:

    from flexflow_tpu_torch.keras import Sequential
    from flexflow_tpu_torch.keras.layers import Dense, Input

    model = Sequential([Input((784,)), Dense(128, activation="relu"),
                        Dense(10, activation="softmax")])
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], batch_size=64)
    model.fit(x, y, epochs=5)

The model runs on the card unless built with ``device="cpu"``
(``Sequential([...], device="cpu")``).
"""

from flexflow_tpu_torch.keras.models import Model, Sequential
from flexflow_tpu_torch.keras import (layers, optimizers, callbacks,
                                      datasets, backend)

__all__ = ["Model", "Sequential", "layers", "optimizers", "callbacks",
           "datasets", "backend"]
