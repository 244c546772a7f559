"""PyTorch port, step tracing and the run's artifacts (``flexflow_tpu_torch/obs``).

Mirrors ``tests/test_observability.py`` where the port has a
counterpart, on the 2-layer BERT-proxy (hidden 32, 2 heads, S 8, batch
4, numpy seeds) on the CPU: a traced ``fit`` writes the trace, the
JSONL stream, the summary, the simulated schedule, the drift report and
the counters, each with the port's header; phase spans nest inside
their steps; a ``fit`` without ``trace_dir`` writes nothing; a crashed
``fit`` still flushes; an unusable directory degrades to the no-op; a
traced ``evaluate``; ``merge_host_traces``. The JAX package's own tools
(``scripts/calibrate.py --ingest-drift``, ``scripts/obs_report.py``)
read the port's artifacts. The summary's FLOPs equal the JAX package's
``train_step_flops`` on the same graph (exact: the same integer sums).
"""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu_torch as P
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
from flexflow_tpu.tensor import Tensor as JTensor
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.models import TransformerConfig, create_transformer
from flexflow_tpu_torch.obs import NULL_TRACER, make_tracer
from flexflow_tpu_torch.obs.registry import CounterRegistry
from flexflow_tpu_torch.obs.tracer import StepTracer, merge_host_traces
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.version import __version__

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_layers=2, hidden_size=32, num_heads=2, seq_length=8,
             batch_size=4)
PHASES = ("data_load", "device_put", "dispatch", "device_wait",
          "metrics_sync")


def _blobs(n=16, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, SMALL["seq_length"], SMALL["hidden_size"])
    y = rs.randn(n, SMALL["seq_length"], 1)
    return x.astype(np.float32), y.astype(np.float32)


def _model(**cfg):
    ff = create_transformer(TransformerConfig(**SMALL),
                            P.FFConfig(batch_size=4, **cfg), device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-3),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    return ff


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"port_obs_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("trace"))
    x, y = _blobs()
    ff = _model()
    ff.fit(x, y, epochs=2, verbose=False, trace_dir=td)
    return td, ff


def _one(td, pattern):
    paths = glob.glob(os.path.join(td, pattern))
    assert len(paths) == 1, f"{pattern}: {paths}"
    return paths[0]


@pytest.mark.parametrize("pattern", [
    "fit_*.trace.json", "fit_*.events.jsonl", "fit_*.summary.json",
    "fit_*.simtrace.json", "fit_*.drift.json", "fit_*.counters.json"])
def test_traced_fit_writes_each_artifact_with_the_ports_header(traced_run,
                                                               pattern):
    td, _ = traced_run
    path = _one(td, pattern)
    if path.endswith(".jsonl"):
        header = json.loads(open(path).readline())
    else:
        data = json.load(open(path))
        header = data.get("metadata") or data["header"]
    assert header["flexflow_tpu_version"] == __version__
    assert header["platform"] == "cpu"
    assert header["host_id"] == 0
    if "counters" not in pattern:  # the registry's snapshot is run-wide
        assert header["run_name"] == "fit"


def test_chrome_trace_with_step_spans(traced_run):
    td, _ = traced_run
    events = json.load(open(_one(td, "fit_*.trace.json")))["traceEvents"]
    steps = [e for e in events if e.get("name") == "step"
             and e.get("ph") == "X"]
    # 16 samples / batch 4 x 2 epochs
    assert len(steps) == 8
    assert all(e["dur"] > 0 for e in steps)
    names = {e["name"] for e in events}
    for phase in PHASES:
        assert phase in names, f"missing phase {phase}"


def test_phase_spans_nest_inside_their_step(traced_run):
    td, _ = traced_run
    events = json.load(open(_one(td, "fit_*.trace.json")))["traceEvents"]
    steps = {e["args"]["step"]: (e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("name") == "step"}
    inner = [e for e in events if e.get("ph") == "X"
             and e["name"] in ("data_load", "device_put", "dispatch",
                               "device_wait")]
    assert len(inner) == 4 * 8
    for e in inner:
        t0, t1 = steps[e["args"]["step"]]
        assert t0 - 1e-3 <= e["ts"] and e["ts"] + e["dur"] <= t1 + 1e-3
    # the epoch read is outside every step
    syncs = [e for e in events if e["name"] == "metrics_sync"]
    assert [e["args"]["epoch"] for e in syncs] == [0, 1]
    assert all("step" not in e["args"] for e in syncs)


def test_jsonl_stream(traced_run):
    td, _ = traced_run
    lines = [json.loads(ln) for ln in open(_one(td, "fit_*.events.jsonl"))]
    assert lines[0]["record"] == "header"
    assert lines[0]["kind"] == "trace"
    assert sum(1 for e in lines[1:] if e["name"] == "step") == 8
    assert lines[0]["num_ops"] == 15
    assert lines[0]["mesh_axes"] == {"data": 1}


def test_summary_fields(traced_run):
    td, ff = traced_run
    summ = json.load(open(_one(td, "fit_*.summary.json")))
    # the JAX package's train-step FLOPs on the same graph
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])
    jff = j_create_transformer(JTransformerConfig(**SMALL),
                               J.FFConfig(batch_size=4))
    nodes, _, _ = jff._materialize_nodes()
    assert summ["flops"] == 3.0 * sum(float(n.op.flops()) for n in nodes)
    assert summ["bytes_accessed"] is None and summ["fusions"] is None
    assert summ["collectives"] == {}
    assert summ["collectives_source"] == "nccl"
    assert summ["collectives_total"] == {"count": 0, "bytes": 0.0}
    mem = summ["memory"]
    want = sum(t.numel() * t.element_size()
               for tree in (ff.params,) for sub in tree.values()
               for t in sub.values())
    assert mem["argument_bytes"] > want > 0
    # the CPU has no device allocator: no device figure is written
    assert mem["peak_bytes"] is None and mem["temp_bytes"] is None
    assert mem["footprint_bytes"] is None and mem["graph_pool_bytes"] is None
    assert mem["feed_bytes"] == 4 * 8 * 32 * 4 + 4 * 8 * 1 * 4
    assert summ["mesh_axes"] == {"data": 1} and summ["num_ops"] == 15


def test_each_traced_fit_reads_its_own_peak(tmp_path):
    """A traced fit starts the step peak afresh: an earlier run's reading
    never reaches its summary (on the CPU nothing is read: null)."""
    ff = _model()
    x, y = _blobs(8)
    ff._step_peak_bytes = 1e15  # an earlier traced run's reading
    td = str(tmp_path / "t")
    ff.fit(x, y, epochs=1, verbose=False, trace_dir=td)
    summ = json.load(open(_one(td, "fit_*.summary.json")))
    assert summ["memory"]["peak_bytes"] is None
    assert summ["memory"]["footprint_bytes"] is None


def test_drift_report(traced_run):
    td, _ = traced_run
    rep = json.load(open(_one(td, "fit_*.drift.json")))
    assert rep["predicted"]["total_s"] > 0
    assert rep["measured"]["step_s"] > 0
    assert rep["ratio"] > 0
    assert rep["predicted"]["num_ops"] == 15
    assert rep["predicted"]["measured_ops"] == 0  # no profile table
    assert all(r["work_div"] == 1 and r["source"] == "analytic"
               for r in rep["per_op"])
    assert rep["comm"] == {} and rep["predicted"]["comm_s"] == 0.0
    assert "dispatch" in rep["phases"]
    assert rep["mesh_axes"] == {"data": 1}
    assert rep["search_predicted_s"] is None


def test_counters_exported(traced_run):
    td, _ = traced_run
    counters = json.load(open(_one(td, "fit_*.counters.json")))
    assert counters["counters"]["executor.train_step_jits"] >= 1


def test_drift_ingestable_by_the_reference_calibrate(traced_run, tmp_path,
                                                     monkeypatch):
    """The JAX package's ``calibrate.py --ingest-drift`` reads the port's
    drift report into CALIBRATION.json rows (here the CPU bucket)."""
    td, _ = traced_run
    mod = _script("calibrate")
    fake_repo = tmp_path / "repo"
    (fake_repo / "scripts").mkdir(parents=True)
    monkeypatch.setattr(mod.os.path, "abspath",
                        lambda p: str(fake_repo / "scripts" / "x.py"))
    assert mod.ingest_drift(td) == 0
    cal = json.load(open(fake_repo / "CALIBRATION.json"))
    rows = [r for r in cal["results"] if r.get("source") == "drift_report"]
    assert len(rows) == 1
    assert rows[0]["model"] == "fit"
    assert rows[0]["predicted_s"] > 0 and rows[0]["actual_s"] > 0


def test_obs_report_renders_the_ports_run(traced_run, tmp_path):
    td, _ = traced_run
    mod = _script("obs_report")
    out = str(tmp_path / "OBS_REPORT.json")
    assert mod.main([td, "--out", out]) == 0
    runs = {r["run_name"]: r for r in json.load(open(out))["runs"]}
    assert runs["fit"]["step_time_p50_s"] > 0


class TestTracerOffIsNoop:
    def test_fit_without_trace_dir_writes_nothing(self, tmp_path,
                                                  monkeypatch):
        monkeypatch.chdir(tmp_path)
        x, y = _blobs(8)
        ff = _model()
        ff.fit(x, y, epochs=1, verbose=False)
        assert os.listdir(str(tmp_path)) == []

    def test_null_tracer_shared_and_inert(self):
        t = make_tracer(None)
        assert t is NULL_TRACER and not t.active
        with t.step():
            with t.phase("anything", foo=1):
                pass
        t.instant("x")
        assert t.export() == {}
        assert t.step_time_s() is None

    def test_crashed_fit_still_flushes_trace(self, tmp_path):
        td = str(tmp_path)
        x, y = _blobs()
        ff = _model()
        real = ff.executor.make_train_step()
        calls = {"n": 0}

        def dying_step(*args):
            calls["n"] += 1
            if calls["n"] > 2:
                raise RuntimeError("injected mid-training failure")
            return real(*args)

        ff.executor.make_train_step = lambda: dying_step
        with pytest.raises(RuntimeError, match="injected"):
            ff.fit(x, y, epochs=2, verbose=False, trace_dir=td)
        trace = json.load(open(glob.glob(
            os.path.join(td, "fit_*.trace.json"))[0]))
        steps = [e for e in trace["traceEvents"]
                 if e.get("name") == "step" and e.get("ph") == "X"]
        assert len(steps) == 3  # 2 completed + the aborted one
        assert glob.glob(os.path.join(td, "fit_*.summary.json")) == []
        assert glob.glob(os.path.join(td, "fit_*.drift.json")) == []
        assert len(glob.glob(os.path.join(td, "fit_*.counters.json"))) == 1

    def test_unusable_trace_dir_degrades_to_noop(self, tmp_path):
        blocker = tmp_path / "not_a_dir"
        blocker.write_text("")
        assert make_tracer(str(blocker / "sub")) is NULL_TRACER
        x, y = _blobs(8)
        ff = _model()
        ff.fit(x, y, epochs=1, verbose=False,
               trace_dir=str(blocker / "sub"))
        assert ff.epoch_losses

    def test_evaluate_traced(self, tmp_path):
        td = str(tmp_path)
        x, y = _blobs(8)
        ff = _model()
        rep = ff.evaluate(x, y, trace_dir=td)
        assert rep["loss"] > 0
        trace = json.load(open(_one(td, "evaluate_*.trace.json")))
        steps = [e for e in trace["traceEvents"] if e.get("name") == "step"]
        assert len(steps) == 2
        assert {"device_put", "dispatch", "metrics_sync"} <= {
            e["name"] for e in trace["traceEvents"]}

    def test_config_trace_dir_traces_fit(self, tmp_path):
        x, y = _blobs(8)
        ff = _model(trace_dir=str(tmp_path))
        ff.fit(x, y, epochs=1, verbose=False)
        assert glob.glob(str(tmp_path / "fit_*.drift.json"))


class TestMergeHostTraces:
    def test_merges_by_host_id(self, tmp_path):
        td = str(tmp_path)
        for host in (0, 1):
            tr = StepTracer(td, host_id=host, run_name="fit")
            with tr.step():
                with tr.phase("dispatch"):
                    pass
            tr.export()
        data = json.load(open(merge_host_traces(td)))
        assert data["metadata"]["merged_hosts"] == [0, 1]
        assert {e["pid"] for e in data["traceEvents"]} == {0, 1}

    def test_repeated_runs_merge_onto_distinct_thread_rows(self, tmp_path):
        td = str(tmp_path)
        for run in ("fit", "evaluate"):
            tr = StepTracer(td, host_id=0, run_name=run)
            with tr.step():
                with tr.phase("dispatch"):
                    pass
            tr.export()
        data = json.load(open(merge_host_traces(td)))
        spans = [e for e in data["traceEvents"] if e.get("ph") == "X"]
        assert len({(e["pid"], e["tid"]) for e in spans}) == 2

    def test_cross_host_clock_shift(self, tmp_path):
        td = str(tmp_path)
        trs = [StepTracer(td, host_id=h, run_name="fit") for h in (0, 1)]
        trs[1]._wall_origin = trs[0]._wall_origin + 0.25
        for tr in trs:
            with tr.step():
                pass
            tr.export()
        data = json.load(open(merge_host_traces(td)))
        steps = {e["pid"]: e for e in data["traceEvents"]
                 if e.get("name") == "step" and e.get("ph") == "X"}
        assert steps[1]["ts"] - steps[0]["ts"] == pytest.approx(0.25e6,
                                                                rel=0.05)

    def test_empty_dir(self, tmp_path):
        assert merge_host_traces(str(tmp_path)) is None


def test_registry_export_stamps_header(tmp_path):
    r = CounterRegistry()
    r.inc("x")
    data = json.load(open(r.export(str(tmp_path / "c.json"))))
    assert data["header"]["flexflow_tpu_version"] == __version__
    assert data["header"]["kind"] == "counters"
    assert data["counters"]["x"] == 1
