"""CANDLE-Uno drug-response model.

PyTorch counterpart of ``flexflow_tpu/models/candle_uno.py`` (after the
original FlexFlow's ``examples/cpp/candle_uno/candle_uno.cc``), with its
default configuration: batch 64; one encoder tower of 8 dense layers of
4192 (ReLU, no bias) for each of the seven inputs (dose 1 and 2,
cell.rnaseq 942, drug 1 and 2 descriptors 5270 and fingerprints 2048),
each input with weights of its own; the towers concatenated (29,344
wide) into a trunk of 4 x 4192 and one regression output.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.ffconst import ActiMode
from flexflow_tpu_torch.model import FFModel


@dataclasses.dataclass
class CandleUnoConfig:
    batch_size: int = 64
    dense_layers: Sequence[int] = (4192,) * 4
    dense_feature_layers: Sequence[int] = (4192,) * 8
    # feature name -> input dim; each input has its own tower
    input_features: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "dose1": 1, "dose2": 1, "cell_rnaseq": 942,
            "drug1_descriptors": 5270, "drug1_fingerprints": 2048,
            "drug2_descriptors": 5270, "drug2_fingerprints": 2048,
        })


def _feature_model(ff: FFModel, t, layers: Sequence[int], name: str):
    for i, width in enumerate(layers):
        t = ff.dense(t, width, activation=ActiMode.AC_MODE_RELU,
                     use_bias=False, name=f"{name}_d{i}")
    return t


def create_candle_uno(cfg: CandleUnoConfig, ff_config: FFConfig = None,
                      device=None) -> FFModel:
    """Build the (uncompiled) model on ``device`` (None = the card). Its
    inputs: one float ``[B, dim]`` tensor per ``input_features`` entry,
    in order."""
    ff = FFModel(ff_config or FFConfig(batch_size=cfg.batch_size),
                 device=device)
    encoded = []
    for fname, dim in cfg.input_features.items():
        t = ff.create_tensor((cfg.batch_size, dim), name=fname)
        encoded.append(_feature_model(ff, t, cfg.dense_feature_layers,
                                      f"enc_{fname}"))
    t = ff.concat(encoded, axis=-1, name="concat_features")
    for i, width in enumerate(cfg.dense_layers):
        t = ff.dense(t, width, activation=ActiMode.AC_MODE_RELU,
                     use_bias=False, name=f"trunk_d{i}")
    ff.dense(t, 1, name="out")  # growth-rate regression
    return ff
