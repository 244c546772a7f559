"""Metrics.

PyTorch counterpart of ``flexflow_tpu/metrics.py``: accuracy, categorical
and sparse CE, MSE, RMSE and MAE. ``Metrics.compute`` returns per-batch
sums as device tensors; the training loop adds them up on the device and
brings them to the host once per epoch into ``PerfMetrics``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from flexflow_tpu_torch.ffconst import LossType, MetricsType


@dataclasses.dataclass
class PerfMetrics:
    """Mirrors the reference's PerfMetrics accumulator fields."""

    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0

    def update(self, other: Dict[str, torch.Tensor], batch: int):
        """Add one sync's worth of metric sums (device tensors or numbers)
        covering ``batch`` samples."""
        self.train_all += batch
        for k, v in other.items():
            if k == "accuracy":
                self.train_correct += int(v)
            else:
                setattr(self, k, getattr(self, k) + float(v))

    def report(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        n = max(self.train_all, 1)
        if self.train_correct:
            out["accuracy"] = self.train_correct / n
        for f in ("cce_loss", "sparse_cce_loss", "mse_loss", "rmse_loss",
                  "mae_loss"):
            v = getattr(self, f)
            if v:
                out[f] = v / n
        return out


class Metrics:
    def __init__(self, loss_type: LossType, metrics: List[MetricsType],
                 preds_are_probs: bool = True):
        self.loss_type = loss_type
        self.metrics = list(metrics)
        # False when the model's final op emits logits (no softmax): the
        # CE metrics then normalize via log_softmax instead of log(p)
        self.preds_are_probs = preds_are_probs

    def _log_probs(self, preds: torch.Tensor) -> torch.Tensor:
        if self.preds_are_probs:
            return torch.log(torch.clamp(preds.float(), 1e-12, 1.0))
        return torch.log_softmax(preds.float(), dim=-1)

    def compute(self, preds: torch.Tensor, labels: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """Per-batch metric sums (not averaged), as device tensors."""
        out: Dict[str, torch.Tensor] = {}
        b = preds.shape[0]
        for m in self.metrics:
            if m == MetricsType.ACCURACY:
                if self.loss_type == LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
                    lab = labels.reshape(b, -1)[:, 0].long()
                    correct = torch.argmax(preds, dim=-1) == lab
                elif preds.dim() >= 2 and preds.shape[-1] > 1:
                    correct = (torch.argmax(preds, dim=-1)
                               == torch.argmax(labels, dim=-1))
                else:
                    correct = ((preds > 0.5).to(torch.int32).reshape(b, -1)[:, 0]
                               == labels.reshape(b, -1)[:, 0])
                out["accuracy"] = torch.sum(correct.to(torch.int32))
            elif m == MetricsType.CATEGORICAL_CROSSENTROPY:
                out["cce_loss"] = -torch.sum(labels * self._log_probs(preds))
            elif m == MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY:
                lab = labels.reshape(b, -1)[:, 0].long()
                out["sparse_cce_loss"] = -torch.sum(torch.gather(
                    self._log_probs(preds), -1, lab[:, None]))
            elif m == MetricsType.MEAN_SQUARED_ERROR:
                out["mse_loss"] = torch.sum(
                    torch.mean((preds - labels) ** 2, dim=-1))
            elif m == MetricsType.ROOT_MEAN_SQUARED_ERROR:
                out["rmse_loss"] = torch.sum(torch.sqrt(
                    torch.mean((preds - labels) ** 2, dim=-1)))
            elif m == MetricsType.MEAN_ABSOLUTE_ERROR:
                out["mae_loss"] = torch.sum(
                    torch.mean(torch.abs(preds - labels), dim=-1))
        return out
