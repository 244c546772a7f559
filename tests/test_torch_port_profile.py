"""PyTorch port, per-op measurement and the predictions built on it.

``flexflow_tpu_torch/search/profile.py``, ``search/validate.py``,
``obs/drift.py``, ``obs/simtrace.py`` and ``obs/roofline.py`` against the
JAX package on the 2-layer BERT-proxy (hidden 32, 2 heads, S 8, batch 4),
on the CPU, both packages' layer counters aligned (``_aligned``) so op
guids agree:
- ``op_cost_key`` is equal for identical ops and differs by shape,
  layout, dtype and device;
- with no ``device`` every measurement entry point means the card and
  raises without one (never the host clock), and a machine spec must
  describe the device it reads;
- ``microbenchmark`` on a CPU model returns the JAX package's key set on
  the same graph (none skipped on either side) and its cache file
  round-trips;
- a TPU or CPU drift bucket never scales a GPU table;
- with one injected measured table, ``graph_optimize`` writes the JAX
  package's strategy JSON (exact, ``json.dumps``);
- on models compiled from one searched strategy: ``predicted_step_time``
  (rel 1e-12: the same float sums), ``simulate_strategy``'s response, the
  simtrace lanes and the corpus rows (exact) equal the JAX package's;
- the roofline rows' FLOPs and bytes equal the reference's (exact);
- ``compile(search_measure_ops=True)``, ``--profiling`` and
  ``--profile-steps`` run.

The host-clock slope's floor (``_MIN_DELTA_S``) is cut to 2 ms in both
packages for the measurements here: the tests check keys, plumbing and
caching, not CPU times.
"""

import json

import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu.obs.drift as jdrift
import flexflow_tpu.obs.simtrace as jsim
import flexflow_tpu.search.profile as jprofile
import flexflow_tpu.search.validate as jvalidate
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.machine import MachineSpec as JMachineSpec
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
from flexflow_tpu.search import unity as junity
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
import flexflow_tpu_torch.obs.drift as pdrift
import flexflow_tpu_torch.obs.simtrace as psim
import flexflow_tpu_torch.search.profile as profile
import flexflow_tpu_torch.search.validate as pvalidate
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.machine import MachineSpec
from flexflow_tpu_torch.models import TransformerConfig, create_transformer
from flexflow_tpu_torch.obs.roofline import format_markdown, roofline_report
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.search import unity
from flexflow_tpu_torch.tensor import Tensor as PTensor

SMALL = dict(num_layers=2, hidden_size=32, num_heads=2, seq_length=8,
             batch_size=4)
CPU = MachineSpec(chip="cpu-sim")
REL = 1e-12


@pytest.fixture(autouse=True)
def _fast_slopes(monkeypatch):
    monkeypatch.setattr(profile, "_MIN_DELTA_S", 0.002)
    monkeypatch.setattr(jprofile, "_MIN_DELTA_S", 0.002)
    monkeypatch.setattr(profile, "_TRIAD_ELEMS", 1 << 16)


def _aligned():
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start


def _pair(**cfg):
    _aligned()
    jff = j_create_transformer(JTransformerConfig(**SMALL),
                               J.FFConfig(batch_size=4, **cfg))
    pff = create_transformer(TransformerConfig(**SMALL),
                             P.FFConfig(batch_size=4, **cfg), device="cpu")
    return jff, pff


def _graph(ff):
    nodes, _, tensor_ref = ff._materialize_nodes()
    return nodes, ff._select_final_ref(nodes, tensor_ref)


def _dumps(x):
    return json.dumps(x, sort_keys=True)


# ---- op_cost_key ------------------------------------------------------------

def _ops(hidden=32):
    ff = create_transformer(TransformerConfig(**dict(SMALL,
                                                     hidden_size=hidden)),
                            P.FFConfig(batch_size=4), device="cpu")
    nodes, _ = _graph(ff)
    return {n.op.name.rsplit("_", 1)[0] if n.op.name != "head"
            else "head": n.op for n in nodes}


def test_op_cost_key_identity_and_its_parts(monkeypatch):
    a, b = _ops(), _ops(hidden=64)

    def key(op, **kw):
        return profile.op_cost_key(op, "cpu", **kw)

    assert key(a["ln1"]) == key(a["ln2"])
    assert key(a["ffn1"]) != key(b["ffn1"])
    assert key(a["ffn1"]) != key(a["ffn1"], layout="NHWC")
    assert key(a["ffn1"]) != key(a["ffn1"], dtype=torch.bfloat16)
    # the device's platform and kind are part of the key: a CPU
    # measurement never prices a card's search, nor one card another's
    names = {"cuda:0": ("gpu", "NVIDIA H100 80GB HBM3"),
             "cuda:1": ("gpu", "NVIDIA A100-SXM4-80GB"),
             "cpu": ("cpu", "x86_64")}
    monkeypatch.setattr(profile, "resolve_device", lambda d: d)
    monkeypatch.setattr(profile, "device_identity",
                        lambda d: names[str(d)])
    keys = {d: profile.op_cost_key(a["ffn1"], d) for d in names}
    assert len(set(keys.values())) == 3


# ---- microbenchmark -----------------------------------------------------------

@pytest.fixture(scope="module")
def measured_pair():
    """Both packages' microbenchmark of one graph (guids aligned)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profile, "_MIN_DELTA_S", 0.002)
        mp.setattr(jprofile, "_MIN_DELTA_S", 0.002)
        mp.setattr(profile, "_TRIAD_ELEMS", 1 << 16)
        mp.setenv("FFS_NO_DRIFT_CORRECTIONS", "1")
        jff, pff = _pair()
        jnodes, _ = _graph(jff)
        pnodes, _ = _graph(pff)
        jm = jprofile.microbenchmark(jnodes)
        pm = profile.microbenchmark(pnodes, machine_spec=CPU, device="cpu")
        yield jnodes, pnodes, jm, pm


def test_microbenchmark_keys_match_the_reference(measured_pair):
    jnodes, pnodes, jm, pm = measured_pair
    assert [n.op.guid for n in jnodes] == [n.op.guid for n in pnodes]
    assert sorted(pm) == sorted(jm)
    # nothing skipped on either side: every node has both legs
    for n in pnodes:
        assert pm[f"{n.op.guid}:fwd"] > 0 and pm[f"{n.op.guid}:bwd"] > 0
    assert pm["__step_overhead__"] > 0 and pm["__update_bw__"] > 0
    # identical ops share one measurement
    by_name = {n.op.name: n.op.guid for n in pnodes}
    assert pm[f"{by_name['ln1_0']}:fwd"] == pm[f"{by_name['ln2_1']}:fwd"]


def test_cache_file_round_trips(tmp_path, monkeypatch):
    _, pff = _pair()
    nodes, _ = _graph(pff)
    cache = tmp_path / "measured.json"
    monkeypatch.setattr(profile, "_CACHE", {})
    first = profile.microbenchmark(nodes, machine_spec=CPU, device="cpu",
                                   cache_file=str(cache))
    on_disk = json.loads(cache.read_text())
    assert all(isinstance(v, list) and len(v) == 2 for v in on_disk.values())
    assert not list(tmp_path.glob(".tmp_*"))  # written atomically
    # a fresh process (empty cache) reads the file and measures nothing
    monkeypatch.setattr(profile, "_CACHE", {})

    def no_measuring(*a, **k):
        raise AssertionError("measured again despite the cache file")

    monkeypatch.setattr(profile, "measure_op", no_measuring)
    monkeypatch.setattr(profile, "_slope", no_measuring)
    again = profile.microbenchmark(nodes, machine_spec=CPU, device="cpu",
                                   cache_file=str(cache))
    assert again == first


def test_microbenchmark_needs_the_machines_bandwidth():
    _, pff = _pair()
    nodes, _ = _graph(pff)
    with pytest.raises(ValueError, match="HBM rate"):
        profile.microbenchmark(nodes)


def test_measurement_entry_points_default_to_the_card(monkeypatch):
    """With no ``device`` every entry point means the card: with none
    present each raises before it times anything, never falling back to
    the host clock; and a card's machine spec never reads CPU times, nor
    the CPU's a card's."""
    _, pff = _pair()
    nodes, _ = _graph(pff)
    op = nodes[0].op
    H100 = MachineSpec(chip="h100-sxm")

    def no_timing(*a, **k):
        raise AssertionError("timed on the host clock")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(profile, "_host_slope", no_timing)
    monkeypatch.setattr(profile, "_CACHE", {})
    calls = [lambda: profile.op_cost_key(op),
             lambda: profile.measure_op(op, CPU.hbm_bw),
             lambda: profile.measure_runtime_constants(),
             lambda: profile.microbenchmark(nodes, machine_spec=CPU),
             lambda: profile.microbenchmark(nodes, hbm_bw=CPU.hbm_bw),
             lambda: roofline_report(nodes, CPU, include_bwd=False)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for call in (lambda: profile.microbenchmark(nodes, machine_spec=H100,
                                                device="cpu"),
                 lambda: roofline_report(nodes, H100, device="cpu")):
        with pytest.raises(ValueError, match="does not describe"):
            call()
    # the byte width is the dtype's; a width that disagrees is refused
    with pytest.raises(ValueError, match="not the width"):
        roofline_report(nodes, CPU, device="cpu", dtype=torch.bfloat16,
                        dtype_size=4.0)


def test_no_literal_tpu_bandwidth_in_the_measurement():
    import inspect
    src = inspect.getsource(profile)
    for figure in ("0.82e12", "8.2e11", "819e9", "820e9"):
        assert figure not in src


@pytest.mark.parametrize("platform,scaled", [("gpu", False), ("cpu", True),
                                             ("tpu", True)])
def test_drift_buckets_scale_only_their_platform(tmp_path, monkeypatch,
                                                 platform, scaled):
    cal = tmp_path / "CALIBRATION.json"
    cal.write_text(json.dumps(dict(op_corrections=dict(
        tpu={"LINEAR": dict(factor=2.0)},
        cpu={"LINEAR": dict(factor=3.0)}))))
    monkeypatch.setenv("FFS_CALIBRATION_FILE", str(cal))
    _, pff = _pair()
    nodes, _ = _graph(pff)
    lin = next(n for n in nodes if n.op.op_type == P.OperatorType.LINEAR)
    table = {f"{lin.op.guid}:fwd": 1.0, f"{lin.op.guid}:bwd": 2.0}
    out = profile.apply_drift_corrections(table, nodes, platform=platform)
    want = {"gpu": 1.0, "cpu": 3.0, "tpu": 2.0}[platform]
    assert out[f"{lin.op.guid}:fwd"] == want
    assert (out != table) == scaled
    # the reference reads the same bucket for the same platform
    if platform != "gpu":
        assert jprofile.load_op_corrections(path=str(cal),
                                            platform=platform) == \
            profile.load_op_corrections(path=str(cal), platform=platform)


def test_a_card_table_is_not_scaled_by_the_repos_calibration():
    """CALIBRATION.json holds cpu and tpu buckets only."""
    assert profile.load_op_corrections(platform="gpu") == {}


@pytest.mark.parametrize("training", [True, False],
                         ids=["training", "inference"])
def test_graph_optimize_on_one_measured_table_matches(measured_pair,
                                                      training):
    _, _, _, table = measured_pair
    jff, pff = _pair(search_budget=2)
    # the pair's guids continue the measured pair's: re-key the table
    _, pnodes0, _, _ = measured_pair
    old = [n.op.guid for n in pnodes0]
    out = []
    for ff, mod, spec in ((jff, junity, JMachineSpec),
                          (pff, unity, MachineSpec)):
        nodes, final = _graph(ff)
        new = {o: n.op.guid for o, n in zip(old, nodes)}
        measured = {(f"{new[int(k.split(':')[0])]}:{k.split(':')[1]}"
                     if ":" in k else k): v for k, v in table.items()}
        cfg = ff.config
        mode = (J.CompMode if isinstance(ff, J.FFModel) else P.CompMode)
        cfg.computation_mode = mode.TRAINING if training else mode.INFERENCE
        cfg.opt_state_factor = 2.0 if training else 0.0
        mesh, st, info = mod.graph_optimize(
            nodes, spec(chip="cpu-sim", chips_per_slice=1), cfg, 1,
            measured=measured, batch=4, final_ref=final)
        out.append((mod.strategy_json(mesh, st,
                                      info.get("rewritten_nodes", nodes),
                                      objective=info["objective"]),
                    info["predicted_time"]))
    assert _dumps(out[1][0]) == _dumps(out[0][0])
    assert out[1][1] == out[0][1]


# ---- predictions on one compiled strategy -------------------------------------

@pytest.fixture(scope="module")
def compiled_pair():
    """Both packages compiled with ``search_budget=2`` on one device (the
    same strategy), Adam; a synthetic measured table over half the ops."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FFS_NO_LEARNED_COSTS", "1")
        jff, pff = _pair(search_budget=2)
        jff.config.workers_per_node = 1
        jff.compile(J.AdamOptimizer(alpha=1e-3),
                    J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                    [J.MetricsType.MEAN_SQUARED_ERROR])
        pff.compile(AdamOptimizer(alpha=1e-3),
                    P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                    [P.MetricsType.MEAN_SQUARED_ERROR])
        rs = np.random.RandomState(3)
        table = {"__step_overhead__": 7e-6}
        for n in pff.executor.nodes[::2]:
            table[f"{n.op.guid}:fwd"] = float(rs.uniform(1e-5, 1e-3))
            table[f"{n.op.guid}:bwd"] = float(rs.uniform(1e-5, 1e-3))
        yield jff, pff, table


def test_the_pair_runs_one_strategy(compiled_pair):
    jff, pff, _ = compiled_pair
    assert {g: s.choice for g, s in pff.strategy.items()} == {
        g: s.choice for g, s in jff.strategy.items()}


def test_predicted_step_time_matches(compiled_pair):
    jff, pff, table = compiled_pair
    want = jdrift.predicted_step_time(jff, measured=table)
    got = pdrift.predicted_step_time(pff, measured=table)
    assert got["measured_ops"] == want["measured_ops"] == 8
    assert got["compute_s"] == pytest.approx(want["compute_s"], rel=REL)
    assert got["step_overhead_s"] == want["step_overhead_s"]
    for g, w in zip(got["per_op"], want["per_op"]):
        assert (g["name"], g["source"], g["work_div"]) == (
            w["name"], w["source"], w["work_div"])
        assert g["fwd_s"] == pytest.approx(w["fwd_s"], rel=REL)
        assert g["bwd_s"] == pytest.approx(w["bwd_s"], rel=REL)


def test_simulate_strategy_matches(compiled_pair):
    jff, pff, _ = compiled_pair
    want = jvalidate.simulate_strategy(jff, learned=False)
    got = pvalidate.simulate_strategy(pff)
    assert _dumps(got) == _dumps(want)
    assert got["iteration_time"] > 0
    assert pvalidate.priced_collectives(pff) == \
        jvalidate.priced_collectives(jff)


def test_simtrace_lanes_and_corpus_rows_match(compiled_pair):
    jff, pff, table = compiled_pair
    resp = pvalidate.simulate_strategy(pff)
    name_of = {i: n.op.name for i, n in enumerate(pff.executor.nodes)}
    jname_of = {i: n.op.name for i, n in enumerate(jff.executor.nodes)}
    got = psim.sim_lane_events(resp["tasks"], name_of, t0_us=100.0)
    want = jsim.sim_lane_events(resp["tasks"], jname_of, t0_us=100.0)
    assert got and _dumps(got) == _dumps(want)
    assert _dumps(psim.corpus_rows(pff, resp, measured=table)) == _dumps(
        jsim.corpus_rows(jff, resp, measured=table))
    assert psim.CORPUS_SCHEMA_VERSION == jsim.CORPUS_SCHEMA_VERSION
    rep = psim.simtrace_report(pff, resp, measured=table)
    jrep = jsim.simtrace_report(jff, resp, measured=table)
    for key in ("corpus_schema", "predicted", "search_predicted_s",
                "mesh_axes", "tasks", "cost_sources"):
        assert _dumps(rep[key]) == _dumps(jrep[key]), key


def test_validator_pieces(compiled_pair):
    _, pff, _ = compiled_pair
    assert pvalidate.emitted_collectives({}) == {}
    census = {"all-reduce": dict(count=2, bytes=8192.0),
              "collective-permute": dict(count=1, bytes=16.0)}
    assert pvalidate.emitted_collectives(census) == {"allreduce": 8192.0}
    assert pvalidate.diff_collectives({}, {}) == []
    assert jvalidate.diff_collectives({"allreduce": 1e6}, {}) == \
        [p.replace("the step emitted", "XLA emitted")
         for p in pvalidate.diff_collectives({"allreduce": 1e6}, {})]
    # a CPU model measured no peak: the memory check says what it needs
    with pytest.raises(ValueError, match="measured peak"):
        pvalidate.predicted_vs_actual_memory(pff)


# ---- roofline -----------------------------------------------------------------

def test_roofline_rows_match_the_reference(compiled_pair):
    jff, pff, _ = compiled_pair
    rep = roofline_report(pff.executor.nodes, CPU, repeats=1, warmup=0,
                          include_bwd=False, device="cpu")
    assert len(rep["rows"]) == len(jff.executor.nodes)
    for row, jn in zip(rep["rows"], jff.executor.nodes):
        assert row["flops"] == float(jn.op.flops())
        assert row["bytes"] == jprofile.op_io_bytes(jn.op, 4.0)
        assert row["fwd_s"] > 0
        assert row["bound_share"] == max(row["mfu"], row["hbm_frac"])
        assert row["over_bound"] == (row["bound_share"] > 1.0)
    md = format_markdown(rep)
    assert "| op | class |" in md


def test_roofline_marks_a_share_over_its_bound():
    rep = dict(rows=[dict(name="x", op_class="other", layout="NCHW",
                          fwd_s=1e-6, achieved_flops=1.0, achieved_bw=1.0,
                          mfu=0.1, bound="bandwidth", flops=1.0, bytes=1.0,
                          hbm_frac=1.5, bound_share=1.5, over_bound=True)],
               classes={}, machine=dict(peak_flops=1.0, ridge_intensity=1.0))
    assert "OVER BOUND" in format_markdown(rep)


# ---- compile, profiling, flags ------------------------------------------------

def test_compile_with_measured_search_and_profiling(capsys):
    _, pff = _pair(search_budget=2)
    pff.config.parse_args(["--search-measure-ops", "--profiling",
                           "--profile-steps", "2:3"])
    pff.compile(AdamOptimizer(alpha=1e-3),
                P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                [P.MetricsType.MEAN_SQUARED_ERROR])
    err = capsys.readouterr().err
    assert "[profiling]" in err and "attn_0: fwd" in err
    assert pff.op_profile is not None
    assert all(f"{n.op.guid}:fwd" in pff.op_profile
               for n in pff.executor.nodes)
    assert pff.search_info["predicted_time"] > 0
    rep = pdrift.predicted_step_time(pff)
    assert rep["measured_ops"] == len(pff.executor.nodes)


def test_a_fused_strategy_file_fails_to_replay_in_both_packages(tmp_path):
    """ROADMAP.md Queue 3: a strategy file giving ops ``dp_k:fused`` on
    one device replays a choice the native core did not spawn; both
    packages fail alike (the port keeps the reference's behaviour)."""
    jff, pff = _pair(workers_per_node=1)
    errors = []
    for ff, pkg in ((jff, J), (pff, P)):
        ops = {layer.name: dict(
            choice=("dp_k:flash" if layer.op_type.name
                    == "MULTIHEAD_ATTENTION" else "dp_k:fused"),
            outputs=[None], params={})
            for layer in ff.layers if layer.op_type.name != "INPUT"}
        path = tmp_path / f"{pkg.__name__}.json"
        path.write_text(json.dumps(dict(version=1, mesh={"data": 1},
                                        ops=ops)))
        ff.config.import_strategy_file = str(path)
        opt = (J.AdamOptimizer if pkg is J else AdamOptimizer)(alpha=1e-3)
        ff.compile(opt, pkg.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
        with pytest.raises(RuntimeError, match="illegal choice") as e:
            (jvalidate.simulate_strategy(ff, learned=False) if pkg is J
             else pvalidate.simulate_strategy(ff))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
