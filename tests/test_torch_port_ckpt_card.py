"""PyTorch port: checkpoint and resume on the card (``cuda``-marked).

A 2-layer BERT-proxy through ``dp_k:flash`` / ``dp_k:fused`` strategy
choices, so that every step runs K1, K2 and K4 as CUDA-graph replays:
four uninterrupted steps against two saved and two resumed in a fresh
model, bit for bit (losses, parameters, bf16 moments, t), with the
resumed steps' kernel launches and replays counted. ``chip_smoke.py``'s
``[ckpt]`` phase runs the same at full width. This file imports no JAX.
"""

import json

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as P
from flexflow_tpu_torch.ckpt.sharded import _capture_state
from flexflow_tpu_torch.ckpt.tree import flatten_tree
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)
from flexflow_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
from flexflow_tpu_torch.ops.fused_update import fused_adam_multi
from flexflow_tpu_torch.optimizers import AdamOptimizer

CFG = dict(num_layers=2, hidden_size=128, num_heads=2, seq_length=128,
           batch_size=4)


def _build(tmp_path):
    cfg = TransformerConfig(**CFG)
    ff = create_transformer(cfg, P.FFConfig(batch_size=4), device="cuda")
    ops = {layer.name: dict(
        choice="dp_k:flash" if layer.op_type == P.OperatorType.
        MULTIHEAD_ATTENTION else "dp_k:fused", outputs=[None], params={})
        for layer in ff.layers if layer.op_type != P.OperatorType.INPUT}
    path = str(tmp_path / "strategy.json")
    with open(path, "w") as f:
        json.dump(dict(version=1, mesh={"data": 1}, ops=ops), f)
    ff.config.import_strategy_file = path
    ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    return ff


def _bits(ff):
    out = {}
    for k, v in flatten_tree(_capture_state(ff)):
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            out[k] = (t.view(torch.int16) if t.dtype == torch.bfloat16
                      else t.view(torch.int32) if t.dtype == torch.float32
                      else t).numpy().copy()
    return out


@pytest.mark.cuda
def test_resume_on_the_card_is_bitwise_through_the_kernels(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the resumed steps' K1, K2 and K4 "
                    "launches inside CUDA-graph replays")
    rs = np.random.RandomState(0)
    x = rs.randn(4, 128, 128).astype(np.float32)
    y = rs.randn(4, 128, 1).astype(np.float32)
    ref = _build(tmp_path)
    ref.fit(x, y, epochs=4, verbose=False)
    want = _bits(ref)
    d = str(tmp_path / "ck")
    _build(tmp_path).fit(x, y, epochs=2, verbose=False, checkpoint_dir=d,
                         checkpoint_every=2)
    ff = _build(tmp_path)
    counts = (flash_fwd.launches, flash_bwd.launches,
              fused_adam_multi.launches)
    ff.fit(x, y, epochs=4, verbose=False, checkpoint_dir=d, resume=True)
    assert ff.epoch_losses == ref.epoch_losses[2:]
    got = _bits(ff)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (flash_fwd.launches - counts[0], flash_bwd.launches - counts[1],
            fused_adam_multi.launches - counts[2]) == (4, 4, 2)
    graph = ff.executor.step_graphs["train_step"]
    assert (graph.captures, graph.replays) == (1, 1)
