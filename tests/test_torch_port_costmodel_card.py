"""PyTorch port: the learned cost model and calibration on the card
(``cuda``-marked).

At a small size, the checks of ``chip_smoke.py``'s ``[costmodel]``
phase:
- traced ``fit``s of a 2-layer BERT-proxy (hidden 128, 2 heads: head dim
  64, so attention runs K1 and K2) at 8 (batch, seq) shapes, compiled
  with ``--profiling``, and the same shapes with attention pinned to the
  einsum core by a strategy file, give a "gpu" corpus; ``costmodel
  train`` fits a "gpu" model whose LINEAR, LAYERNORM and both attention
  classes (MULTIHEAD_ATTENTION:flash, MULTIHEAD_ATTENTION) pass
  MIN_CLASS_ROWS;
- the search of a held-out shape under that model
  (``FFS_COSTMODEL_FILE``) reports ``cost_model == "learned"``; a traced
  ``fit`` of its strategy launches K1 and K2 once per flash attention a
  step (the counters) and its simtrace carries learned sources and the
  analytic twin; on the CPU the same file prices nothing;
- ``calibrate --quick`` on the card writes rows with the card's
  ``mem_ratio`` into ``FFS_CALIBRATION_FILE``, whose median the search's
  ``_memory_correction`` reads.
This file imports no JAX.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as P
from flexflow_tpu_torch.costmodel import MIN_CLASS_ROWS, CostModel
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)
from flexflow_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.scripts import calibrate, costmodel
from flexflow_tpu_torch.search import profile, unity

WIDTH = dict(num_layers=2, hidden_size=128, num_heads=2)
SHAPES = [(b, s) for b in (2, 4, 8, 16) for s in (64, 128)]
HELD_OUT = (4, 256)
STEPS = 3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the corpus is per-op times taken "
                    "on it and the fits run K1 and K2")


def _build(batch, seq, argv=(), device="cuda", einsum_file=None):
    """The model compiled under ``argv``; with ``einsum_file``, through a
    strategy file written there that pins attention to the einsum core."""
    cfg = TransformerConfig(seq_length=seq, batch_size=batch, **WIDTH)
    fcfg = P.FFConfig(batch_size=batch)
    assert fcfg.parse_args(list(argv)) == []
    ff = create_transformer(cfg, fcfg, device=device)
    if einsum_file:
        ops = {layer.name: dict(
            choice="rep_k:einsum" if layer.op_type == P.OperatorType.
            MULTIHEAD_ATTENTION else "rep", outputs=[None], params={})
            for layer in ff.layers if layer.op_type != P.OperatorType.INPUT}
        with open(einsum_file, "w") as f:
            json.dump(dict(version=1, mesh={"data": 1}, ops=ops), f)
        ff.config.import_strategy_file = einsum_file
    ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    rs = np.random.RandomState(0)
    x = rs.randn(batch * STEPS, seq, WIDTH["hidden_size"])
    y = rs.randn(batch * STEPS, seq, 1)
    return ff, x.astype(np.float32), y.astype(np.float32)


@pytest.mark.cuda
def test_learned_search_on_a_card_corpus(tmp_path, monkeypatch):
    _need_card()
    monkeypatch.delenv("FFS_NO_LEARNED_COSTS", raising=False)
    monkeypatch.setenv("FFS_COSTMODEL_FILE", os.devnull)
    profile._CACHE.clear()
    dirs = []
    for batch, seq in SHAPES:
        for core in ("flash", "einsum"):
            pin = (str(tmp_path / f"einsum_b{batch}_s{seq}.json")
                   if core == "einsum" else None)
            ff, x, y = _build(batch, seq, ["--profiling"], einsum_file=pin)
            d = str(tmp_path / f"b{batch}_s{seq}_{core}")
            ff.fit(x, y, epochs=1, verbose=False, trace_dir=d)
            dirs.append(d)
    model_path = str(tmp_path / "COSTMODEL_GPU.json")
    argv = ["train", "--corpus", str(tmp_path / "corpus.json"), "--out",
            model_path]
    for d in dirs:
        argv += ["--trace-dir", d]
    assert costmodel.main(argv) == 0
    model = CostModel.load(model_path)
    assert model.platform == "gpu"
    for name in ("LINEAR", "LAYERNORM", "MULTIHEAD_ATTENTION:flash",
                 "MULTIHEAD_ATTENTION"):
        assert name in model.classes, name
        assert model.classes[name].n_train + model.classes[name].n_test \
            >= MIN_CLASS_ROWS

    monkeypatch.setenv("FFS_COSTMODEL_FILE", model_path)
    ff, x, y = _build(*HELD_OUT, ["--budget", "2"])
    assert ff.search_info["cost_model"] == "learned"
    assert "MULTIHEAD_ATTENTION:flash" in \
        ff.search_info["learned_cost_classes"]
    flash = sum(1 for v in unity.executed_kernel_choices(
        ff.executor.nodes, ff.strategy, ff.mesh.shape, training=True,
        device=ff.device).values() if v == "flash")
    assert flash == WIDTH["num_layers"]
    before = (flash_fwd.launches, flash_bwd.launches)
    td = str(tmp_path / "learned")
    ff.fit(x, y, epochs=1, verbose=False, trace_dir=td)
    assert (flash_fwd.launches - before[0], flash_bwd.launches - before[1]) \
        == (flash * STEPS, flash * STEPS)
    (path,) = glob.glob(os.path.join(td, "fit_*.simtrace.json"))
    sim = json.load(open(path))
    assert sim["header"]["platform"] == "gpu"
    assert sim["cost_sources"].get("learned", 0) > 0
    assert sim["predicted_analytic"]["step_s"] > 0

    # the same file never prices a search on the CPU
    cpu, _, _ = _build(*HELD_OUT, ["--budget", "2"], device="cpu")
    assert cpu.search_info["cost_model"] == "analytic"


@pytest.mark.cuda
def test_quick_calibration_on_the_card(tmp_path, monkeypatch):
    _need_card()
    path = tmp_path / "CALIBRATION_GPU.json"
    monkeypatch.setenv("FFS_CALIBRATION_FILE", str(path))
    rc = calibrate.main(["--quick", "--device", "cuda"])
    assert rc in (0, 1)
    cal = json.load(open(path))
    assert cal["platform"] == "gpu"
    assert cal["device"] == torch.cuda.get_device_name(0)
    ratios = sorted(r["mem_ratio"] for r in cal["results"])
    assert len(ratios) == 3 and all(r > 0 for r in ratios)
    assert all(r["actual_mem_bytes"] > 0 for r in cal["results"])
    assert unity._memory_correction() == ratios[1]
