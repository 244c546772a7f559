"""Loss functions.

PyTorch counterpart of ``flexflow_tpu/losses.py``: categorical CE,
sparse categorical CE, MSE (avg/sum reduce) and identity, each a scalar
f32 objective that autograd seeds.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import LossType


def categorical_crossentropy(logits, labels):
    """labels one-hot [B, C]; logits pre-softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(labels * logp, dim=-1))


def sparse_categorical_crossentropy(logits, labels):
    """[B, C] logits with [B]/[B,1] labels (classification), or [B, S, V]
    logits with [B, S]/[B,S,1] labels (token-level LM objective)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if logits.dim() == 3:
        lab = labels.reshape(labels.shape[0], labels.shape[1], -1)[..., :1]
        return -torch.mean(torch.gather(logp, -1, lab.long()))
    labels = (labels.reshape(labels.shape[0], -1)[..., 0]
              if labels.dim() > 1 else labels)
    return -torch.mean(torch.gather(logp, -1, labels[:, None].long()))


def mse_avg(preds, labels):
    return torch.mean((preds.float() - labels.float()) ** 2)


def mse_sum(preds, labels):
    per_sample = torch.sum((preds.float() - labels.float()) ** 2,
                           dim=tuple(range(1, preds.dim())))
    return torch.mean(per_sample)


def identity(preds, labels):
    return torch.mean(preds.float())


LOSS_FNS = {
    LossType.CATEGORICAL_CROSSENTROPY: categorical_crossentropy,
    LossType.SPARSE_CATEGORICAL_CROSSENTROPY: sparse_categorical_crossentropy,
    LossType.MEAN_SQUARED_ERROR_AVG_REDUCE: mse_avg,
    LossType.MEAN_SQUARED_ERROR_SUM_REDUCE: mse_sum,
    LossType.IDENTITY: identity,
}


def get_loss_fn(loss_type: LossType):
    return LOSS_FNS[loss_type]
