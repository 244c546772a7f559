"""PyTorch port: measurement and tracing on the card (``cuda``-marked).

A 2-layer BERT-proxy (hidden 128, 2 heads, S 128, batch 4) on the card,
the checks of ``chip_smoke.py``'s ``[obs]`` phase at a small size:
- a compile under ``search_measure_ops`` measures every node, and the
  attention's measurement launches K1 and K2 (launch-counter deltas);
  the roofline of the measured ops has no share over its bound;
- a traced ``fit`` through ``dp_k:flash`` / ``dp_k:fused`` choices (K1,
  K2, K4 every step) over 6 steps with the window "2:4": the six
  artifacts parse and name the card, each window step's compute + host
  + idle is its window within 1%, the labels name K1, K2 and K4 with the
  counters' launches, every device lane lies inside a step;
- each traced fit's summary holds its own run's peak, and the footprint
  adds the graph pool;
- a window that opens on the capturing step names it and leaves it out;
- an untraced ``fit`` writes nothing.
This file imports no JAX.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as P
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)
from flexflow_tpu_torch.obs.roofline import roofline_report
from flexflow_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
from flexflow_tpu_torch.ops.fused_update import fused_adam_multi
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.search import profile

CFG = dict(num_layers=2, hidden_size=128, num_heads=2, seq_length=128,
           batch_size=4)
STEPS = 6
ARTIFACTS = ("trace.json", "events.jsonl", "summary.json", "drift.json",
             "devtrace.json", "counters.json")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the measurement and the device "
                    "trace run K1, K2 and K4 on it")


def _counts():
    return dict(fwd=flash_fwd.launches, bwd=flash_bwd.launches,
                adam=fused_adam_multi.launches)


def _build(tmp_path, argv=(), strategy=True):
    cfg = TransformerConfig(**CFG)
    fcfg = P.FFConfig(batch_size=4)
    assert fcfg.parse_args(list(argv)) == []
    ff = create_transformer(cfg, fcfg, device="cuda")
    if strategy:
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


def _batches(n):
    rs = np.random.RandomState(0)
    x = rs.randn(4 * n, CFG["seq_length"], CFG["hidden_size"])
    y = rs.randn(4 * n, CFG["seq_length"], 1)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.cuda
def test_measured_search_runs_the_kernels(tmp_path):
    _need_card()
    profile._CACHE.clear()
    before = _counts()
    ff = _build(tmp_path, ["--budget", "2", "--search-measure-ops",
                           "--measured-cache", str(tmp_path / "m.json")],
                strategy=False)
    after = _counts()
    assert after["fwd"] > before["fwd"] and after["bwd"] > before["bwd"]
    nodes, _, _ = ff._materialize_nodes()
    table = profile.microbenchmark(nodes, machine_spec=ff.machine_spec,
                                   device=ff.device,
                                   dtype=ff.executor.compute_dtype)
    assert all(table[f"{n.op.guid}:fwd"] > 0 for n in nodes)
    assert table["__step_overhead__"] > 0 and table["__update_bw__"] > 0
    assert json.loads((tmp_path / "m.json").read_text())
    rep = roofline_report(nodes, ff.machine_spec, device=ff.device,
                          dtype=ff.executor.compute_dtype, include_bwd=False)
    assert not [r["name"] for r in rep["rows"] if r.get("over_bound")]


@pytest.mark.cuda
def test_traced_fit_names_the_kernels(tmp_path):
    _need_card()
    ff = _build(tmp_path)
    x, y = _batches(STEPS)
    td = str(tmp_path / "trace")
    before = _counts()
    ff.fit(x, y, epochs=1, verbose=False, trace_dir=td, profile_steps="2:4")
    per_step = {k: (v - before[k]) // STEPS for k, v in _counts().items()}
    assert per_step == dict(fwd=2, bwd=2, adam=1)
    name = torch.cuda.get_device_name(0)
    paths = {}
    for suffix in ARTIFACTS:
        found = glob.glob(os.path.join(td, f"fit_*.{suffix}"))
        assert len(found) == 1, suffix
        with open(found[0]) as f:
            head = (json.loads(f.readline()) if suffix.endswith("jsonl")
                    else (lambda d: d.get("metadata") or d["header"])(
                        json.load(f)))
        assert head["platform"] == "gpu" and head["device"] == name
        paths[suffix] = found[0]
    dv = json.load(open(paths["devtrace.json"]))
    assert dv["steps"] == 2 and dv["device_events"] > 0
    for row in dv["per_step"]:
        parts = row["compute_s"] + row["host_s"] + row["idle_s"]
        assert abs(parts - row["wall_s"]) <= 0.01 * row["wall_s"]
        for lab in ("flash_attn_fwd", "flash_attn_bwd", "fused_adam"):
            assert row["per_label"][lab]["time_s"] > 0
        assert row["launches"]["flash_fwd.launches"] == per_step["fwd"]
        assert row["launches"]["flash_bwd.launches"] == per_step["bwd"]
        assert row["launches"]["fused_adam_multi.launches"] == \
            per_step["adam"]
    trace = json.load(open(paths["trace.json"]))
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
             if e.get("name") == "step" and e.get("ph") == "X"]
    lanes = [e for e in trace["traceEvents"]
             if e.get("cat") == "devtrace" and e.get("ph") == "X"]
    assert lanes
    for e in lanes:
        mid = e["ts"] + e["dur"] / 2
        assert any(a - 1e3 <= mid <= b + 1e3 for a, b in spans)
    summ = json.load(open(paths["summary.json"]))
    assert summ["memory"]["peak_bytes"] > summ["memory"]["argument_bytes"]
    assert summ["memory"]["graph_pool_bytes"] > 0
    drift = json.load(open(paths["drift.json"]))
    assert 0 < drift["step_metrics"]["mfu"] < 1


@pytest.mark.cuda
def test_each_traced_fit_reads_its_own_peak(tmp_path):
    """Two traced fits of different batch sizes: the first runs beside
    1 GiB held on the card, the second after it is freed. Each summary
    holds its own run's peak, and the footprint adds the graph pool."""
    _need_card()
    ff = _build(tmp_path)
    x, y = _batches(3)
    held = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    ff.fit(x, y, batch_size=4, epochs=1, verbose=False,
           trace_dir=str(tmp_path / "a"))
    del held
    ff.fit(x, y, batch_size=2, epochs=1, verbose=False,
           trace_dir=str(tmp_path / "b"))
    mem = [json.load(open(glob.glob(str(tmp_path / d / "*.summary.json"))[0]
                          ))["memory"] for d in "ab"]
    assert mem[0]["peak_bytes"] - mem[1]["peak_bytes"] > (1 << 29)
    for m in mem:
        assert m["footprint_bytes"] >= m["argument_bytes"] > 0
        assert m["temp_bytes"] == m["footprint_bytes"] - m["argument_bytes"]
        assert m["graph_pool_bytes"] > 0


@pytest.mark.cuda
def test_a_window_on_the_capturing_step_is_refused(tmp_path):
    _need_card()
    ff = _build(tmp_path)
    x, y = _batches(3)
    td = str(tmp_path / "trace")
    ff.fit(x, y, epochs=1, verbose=False, trace_dir=td, profile_steps="0:2")
    dv = json.load(open(glob.glob(os.path.join(td, "*.devtrace.json"))[0]))
    assert list(dv["refused_steps"]) == ["0"]
    assert "captured the CUDA graph" in dv["refused_steps"]["0"]
    assert [r["step"] for r in dv["per_step"]] == [1]


@pytest.mark.cuda
def test_untraced_fit_writes_nothing(tmp_path, monkeypatch):
    _need_card()
    ff = _build(tmp_path)
    x, y = _batches(2)
    run = tmp_path / "run"
    run.mkdir()
    monkeypatch.chdir(run)
    ff.fit(x, y, epochs=1, verbose=False)
    assert os.listdir(str(run)) == []
