"""PyTorch port, the fflint and explain CLIs
(``python -m flexflow_tpu_torch.scripts.{fflint,explain}``) against the
JAX package's ``scripts/fflint.py`` and ``scripts/explain.py``.

- ``fflint --all --json --device cpu``: the port plans each zoo model
  over 8 devices (the JAX package's virtual CPU slice, where its CLI
  compiles); for every model, the two MoE models included, its
  ``lint_one`` report, the entry ``--all`` writes, equals the JAX CLI's
  (models built from one layer counter); the merge, once over a stubbed
  ``lint_one``: the two MoE entries are reports, built and linted, and
  the exit code is 0.
- ``--budget 2 --edges``: the searched strategy's report and its per-edge
  reshard rows equal the JAX CLI's.
- ``explain --model mlp --budget 1``: the three artifacts, with the JAX
  package's test's assertions (``tests/test_search_trace.py``); with
  ``--trace-dir`` it merges a traced fit's lanes, a devtrace capture's
  ``device:*`` lanes included.
- The measured table (``search/profile.py`` ``microbenchmark``), which
  ``explain --measure-ops`` writes: with a stubbed timer, an attention op
  the flash kernel takes has its einsum rows "<guid>:fwd"/":bwd" (the
  native core's default lowering) and its kernel rows
  "<guid>:fwd:flash"/":bwd:flash"; the CPU runs no kernel and keeps the
  plain rows only, as the JAX package does. Every reader prices the
  core that runs: a corpus row, ``--profiling``'s printout, the drift
  prediction and ``calibrate``'s simulator request read the flash rows
  of an attention op that runs flash.
- A roofline report's bytes at its element width: a bf16 report of one
  dense gives the corpus its parameter bytes within 1%, and an f32
  report reads as the JAX package's corpus reads it.
- ``cuda``-marked: both CLIs on the card (one device).
"""

import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as P
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.tensor import Tensor as JTensor
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.machine import MachineSpec
from flexflow_tpu_torch.models import TransformerConfig, create_transformer
from flexflow_tpu_torch.scripts import explain as pexplain
from flexflow_tpu_torch.scripts import fflint as pfflint
from flexflow_tpu_torch.tensor import Tensor as PTensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_MOE = [m for m in pfflint.ZOO if not m.startswith("moe")]
MOE = [m for m in pfflint.ZOO if m.startswith("moe")]
CPU = MachineSpec(chip="cpu-sim")


def _reference_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"_ffs_ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _no_calibration(tmp_path, monkeypatch):
    # neither package's repo-root calibration file colours the reports
    monkeypatch.setenv("FFS_CALIBRATION_FILE", str(tmp_path / "none.json"))


def _starts():
    starts = []
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        s = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = s
        starts.append(s)
    return starts


def _settle():
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


@pytest.mark.parametrize("name", NOT_MOE + MOE)
def test_all_json_entry_equals_the_reference(name):
    """The entry ``--all`` writes for ``name`` is its ``lint_one`` report
    (``test_all_json_moe_entries_name_item_9d`` checks the merge): the
    port's, planned over 8 devices on the CPU, equals the JAX CLI's, both
    built from one layer counter."""
    args = types.SimpleNamespace(layout="auto", budget=0, hlo=False,
                                 edges=False, device="cpu")
    starts = _starts()
    want = _reference_cli("fflint").lint_one(name, args).to_json()
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    got = pfflint.lint_one(name, args).to_json()
    _settle()
    assert got == want
    assert got["context"]["mesh_axes"] == want["context"]["mesh_axes"]
    assert sum(got["context"]["mesh_axes"].values()) >= 1


def test_all_json_moe_entries_name_item_9d(monkeypatch, capsys):
    """``--all --json``'s merge and exit code, once: every zoo name in
    order, each non-MoE entry the report its ``lint_one`` returned (here
    the cheap mlp's, built anew for each name), the MoE entries, which
    raised naming item 9d before the port had the MoE ops, their own
    reports with no error, exit 0."""
    real = pfflint.lint_one
    reports = {}

    def lint_one(name, args):
        if name.startswith("moe"):
            return real(name, args)
        rep = real("mlp", args)
        rep.context["model"] = name
        reports[name] = rep.to_json()
        return rep

    monkeypatch.setattr(pfflint, "lint_one", lint_one)
    rc = pfflint.main(["--all", "--json", "--device", "cpu"])
    out, err = capsys.readouterr()
    doc = json.loads(out)
    _settle()
    assert list(doc) == pfflint.ZOO
    for name in MOE:
        assert "error" not in doc[name]
        assert doc[name]["context"]["model"] == name
        assert doc[name]["counts"]["error"] == 0
        assert "build/compile failed" not in err
    assert rc == 0
    assert all(doc[m] == reports[m] for m in NOT_MOE)
    assert all(set(doc[m]) == {"context", "passes", "counts",
                               "diagnostics"} for m in pfflint.ZOO)


@pytest.mark.parametrize("name", ["mlp", "resnet", "llama"])
def test_searched_edges_equal_the_reference(name):
    args = types.SimpleNamespace(layout="auto", budget=2, hlo=False,
                                 edges=True, device="cpu")
    starts = _starts()
    want = _reference_cli("fflint").lint_one(name, args).to_json()
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    got = pfflint.lint_one(name, args).to_json()
    _settle()
    assert got == want
    assert got["context"]["searched"] is True
    assert got["context"]["edge_reshards"] == \
        want["context"]["edge_reshards"]


def test_cli_entry_point_exit_codes(tmp_path):
    out = tmp_path / "mlp.json"
    env = dict(os.environ, FFS_CALIBRATION_FILE=str(tmp_path / "n.json"))
    proc = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.scripts.fflint",
         "--model", "mlp", "--json", "--device", "cpu", "--edges",
         "--lint-out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc == json.loads(out.read_text())
    assert doc["context"]["mesh_axes"] == {"data": 8}
    assert doc["context"]["edge_reshards"] == []
    proc = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.scripts.fflint",
         "--model", "nosuchmodel", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and "unknown --model 'nosuchmodel'" \
        in proc.stderr


def _explain_asserts(out):
    st = json.load(open(os.path.join(out, "SEARCH_TRACE.json")))
    assert st["search_trace"]["schema_version"] == 1
    assert st["corpus"]
    assert st["corpus"][0]["priced"]
    md = open(os.path.join(out, "EXPLAIN.md")).read()
    assert "Chosen vs runner-up" in md
    assert "Mesh candidates" in md
    assert "Simulated timeline path" in md
    merged = json.load(open(st["merged_trace"]))
    labels = {e["args"]["name"] for e in merged["traceEvents"]
              if e.get("name") == "thread_name"}
    assert any("sim:compute" in l for l in labels)
    return st, labels


def test_explain_end_to_end(tmp_path):
    out = str(tmp_path / "out")
    assert pexplain.main(["--model", "mlp", "--budget", "1", "--out-dir",
                          out, "--device", "cpu"]) == 0
    st, _ = _explain_asserts(out)
    assert st["model"] == "mlp" and "measured_ops" not in st


def test_explain_merges_a_traced_fits_device_lanes(tmp_path):
    """A traced CPU fit's trace, with the lanes a devtrace capture adds
    to it on the card (``device:compute``/``device:comms`` events of
    category ``devtrace``), merges beside the sim lanes."""
    from flexflow_tpu_torch.obs.devtrace import LANE_THREADS, TID_COMPUTE
    from flexflow_tpu_torch.models import create_mlp
    from flexflow_tpu_torch.optimizers import SGDOptimizer
    td = str(tmp_path / "trace")
    ff = create_mlp(batch_size=16, in_dim=64, hidden_dims=(128, 128),
                    out_dim=10, ff_config=P.FFConfig(batch_size=16),
                    device="cpu")
    ff.compile(SGDOptimizer(lr=0.01),
               P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    rs = np.random.RandomState(0)
    x = rs.randn(64, 64).astype(np.float32)
    y = rs.randint(0, 10, (64, 1)).astype(np.int32)
    ff.fit(x, y, epochs=1, verbose=False, trace_dir=td)
    (path,) = [os.path.join(td, p) for p in os.listdir(td)
               if p.endswith(".trace.json")]
    data = json.load(open(path))
    step = next(e for e in data["traceEvents"]
                if e.get("name") == "step" and e.get("ph") == "X")
    data["traceEvents"] += [
        dict(name="thread_name", ph="M", pid=0, tid=tid, args=dict(name=n))
        for tid, n in LANE_THREADS.items()]
    data["traceEvents"].append(dict(
        name="flash_fwd", ph="X", tid=TID_COMPUTE, pid=0, ts=step["ts"],
        dur=10.0, cat="devtrace", args=dict(label="flash_fwd")))
    with open(path, "w") as f:
        json.dump(data, f)
    out = str(tmp_path / "out")
    assert pexplain.main(["--model", "mlp", "--budget", "1", "--out-dir",
                          out, "--trace-dir", td, "--device", "cpu"]) == 0
    st, labels = _explain_asserts(out)
    assert os.path.dirname(st["merged_trace"]) == td
    assert any(l.endswith(":sim:comms") for l in labels)
    assert any(l.endswith(":device:compute") for l in labels), labels
    merged = json.load(open(st["merged_trace"]))
    assert any(e.get("cat") == "devtrace" and e.get("name") == "flash_fwd"
               for e in merged["traceEvents"])


# ---- the measured table: one row set per attention core ---------------------

def _attention_nodes(head_dim=64):
    ff = create_transformer(TransformerConfig(num_layers=1,
                                              hidden_size=head_dim,
                                              num_heads=1, seq_length=64,
                                              batch_size=2), device="cpu")
    nodes, _, _ = ff._materialize_nodes()
    att = next(n for n in nodes
               if n.op.op_type.name == "MULTIHEAD_ATTENTION")
    return nodes, att.op


def test_flash_runs_only_where_the_kernel_takes_the_op():
    from flexflow_tpu_torch.search.profile import _flash_runs
    nodes, att = _attention_nodes(64)
    assert _flash_runs(att, torch.device("cuda"))
    assert not _flash_runs(att, torch.device("cpu"))
    assert att.kernel_impl is None
    _, att32 = _attention_nodes(32)  # a head_dim the kernel does not take
    assert not _flash_runs(att32, torch.device("cuda"))
    lin = next(n.op for n in nodes if n.op.op_type.name == "LINEAR")
    assert not _flash_runs(lin, torch.device("cuda"))


def test_measured_table_holds_both_attention_cores(monkeypatch):
    from flexflow_tpu_torch.search import profile
    nodes, att = _attention_nodes(64)
    seen = []

    def timer(op, hbm_bw, device=None, dtype=None, layout=None, **kw):
        impl = getattr(op, "kernel_impl", None)
        seen.append((op.name, impl))
        t = {"einsum": 3e-3, "flash": 1e-3}.get(impl, 5e-4)
        key = profile.op_cost_key(op, device, layout, dtype)
        profile._CACHE[key] = (t, 2 * t)
        return profile._CACHE[key]

    monkeypatch.setattr(profile, "_CACHE", {})
    monkeypatch.setattr(profile, "measure_op", timer)
    monkeypatch.setattr(profile, "measure_runtime_constants", lambda d: {})
    monkeypatch.setattr(profile, "_flash_runs",
                        lambda op, device: op is att)
    table = profile.microbenchmark(nodes, machine_spec=CPU, device="cpu",
                                   drift_corrections=False)
    g = att.guid
    assert table[f"{g}:fwd"] == 3e-3 and table[f"{g}:bwd"] == 6e-3
    assert table[f"{g}:fwd:flash"] == 1e-3 and table[f"{g}:bwd:flash"] \
        == 2e-3
    assert att.kernel_impl is None  # the pins are the table's, not the op's
    assert [i for n, i in seen if n == att.name] == ["einsum", "flash"]
    # every other op: its plain rows, timed unpinned
    for n in nodes:
        if n.op is not att:
            assert f"{n.op.guid}:fwd:flash" not in table
            assert table[f"{n.op.guid}:fwd"] == 5e-4
    # the einsum row is the einsum-pinned measurement, keyed apart from
    # the unpinned and the flash ones (the cache keeps all three apart)
    keys = set()
    for pin in (None, "einsum", "flash"):
        att.kernel_impl = pin
        keys.add(profile.op_cost_key(att, "cpu", "NCHW", torch.float32))
    att.kernel_impl = None
    assert len(keys) == 3


def test_measured_table_on_the_cpu_keeps_the_plain_rows(monkeypatch):
    from flexflow_tpu_torch.search import profile
    nodes, att = _attention_nodes(64)
    monkeypatch.setattr(profile, "_CACHE", {})
    monkeypatch.setattr(profile, "measure_op",
                        lambda op, *a, **kw: profile._CACHE.__setitem__(
                            profile.op_cost_key(op, kw.get("device"),
                                                kw.get("layout"),
                                                kw.get("dtype")),
                            (1e-4, 2e-4)))
    monkeypatch.setattr(profile, "measure_runtime_constants", lambda d: {})
    table = profile.microbenchmark(nodes, machine_spec=CPU, device="cpu",
                                   drift_corrections=False)
    assert sorted(table) == sorted(f"{n.op.guid}:{leg}" for n in nodes
                                   for leg in ("fwd", "bwd"))


def test_corpus_rows_read_the_executed_cores_row():
    from flexflow_tpu_torch.obs.simtrace import corpus_rows
    from flexflow_tpu_torch.optimizers import SGDOptimizer
    from flexflow_tpu_torch.search.validate import simulate_strategy
    ff = create_transformer(TransformerConfig(num_layers=1, hidden_size=64,
                                              num_heads=1, seq_length=64,
                                              batch_size=2), device="cpu")
    ff.compile(SGDOptimizer(lr=0.01),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    att = next(n.op for n in ff.executor.nodes
               if n.op.op_type.name == "MULTIHEAD_ATTENTION")
    g = att.guid
    measured = {f"{g}:fwd": 3e-3, f"{g}:bwd": 6e-3}
    resp = simulate_strategy(ff)
    row = next(r for r in corpus_rows(ff, resp, measured)
               if r["guid"] == g)
    assert row["impl"] == "einsum" and row["measured"]["fwd_s"] == 3e-3
    att.kernel_impl = "flash"
    measured.update({f"{g}:fwd:flash": 1e-3, f"{g}:bwd:flash": 2e-3})
    row = next(r for r in corpus_rows(ff, resp, measured)
               if r["guid"] == g)
    assert row["impl"] == "flash" and row["measured"]["fwd_s"] == 1e-3 \
        and row["measured"]["bwd_s"] == 2e-3


def test_profiling_and_calibration_read_the_flash_row(monkeypatch, capsys):
    """An attention op that runs the flash core: ``--profiling``'s table
    (``ff.op_profile``) keeps both cores' rows, and its printout, the
    drift prediction and calibrate's simulator request all price the
    flash rows, not the einsum rows that "<guid>:fwd" holds."""
    from flexflow_tpu_torch.obs.drift import predicted_step_time
    from flexflow_tpu_torch.optimizers import SGDOptimizer
    from flexflow_tpu_torch.scripts.calibrate import (predicted_step,
                                                      step_request)
    from flexflow_tpu_torch.search import profile

    def timer(op, hbm_bw, device=None, dtype=None, layout=None, **kw):
        impl = getattr(op, "kernel_impl", None)
        t = {"einsum": 3e-3, "flash": 1e-3}.get(impl, 5e-6)
        key = profile.op_cost_key(op, device, layout, dtype)
        profile._CACHE[key] = (t, 2 * t)
        return profile._CACHE[key]

    monkeypatch.setattr(profile, "_CACHE", {})
    monkeypatch.setattr(profile, "measure_op", timer)
    monkeypatch.setattr(profile, "measure_runtime_constants", lambda d: {})
    monkeypatch.setattr(profile, "_flash_runs", lambda op, device:
                        op.op_type.name == "MULTIHEAD_ATTENTION")
    # attention dispatches as on the card: the flash core unless pinned
    # to einsum (the CPU runs the core's plain version)
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention
    monkeypatch.setattr(
        MultiHeadAttention, "selected_impl",
        lambda self, device="cuda", mesh_axes=None, training=False:
        "einsum" if self.kernel_impl == "einsum" else "flash")
    ff = create_transformer(TransformerConfig(num_layers=1, hidden_size=64,
                                              num_heads=1, seq_length=128,
                                              batch_size=2),
                            P.FFConfig(batch_size=2, profiling=True),
                            device="cpu")
    ff.compile(SGDOptimizer(lr=0.01),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    att = next(n.op for n in ff.executor.nodes
               if n.op.op_type.name == "MULTIHEAD_ATTENTION")
    g = att.guid
    table = ff.op_profile
    assert table[f"{g}:fwd"] == 3e-3 and table[f"{g}:fwd:flash"] == 1e-3
    err = capsys.readouterr().err
    printed = [l for l in err.splitlines() if f"{att.name}: fwd" in l]
    assert len(printed) == 1 and printed[0].endswith(
        "fwd    1000.0us  bwd    2000.0us  [flash]")
    row = next(r for r in predicted_step_time(ff)["per_op"]
               if r["guid"] == g)
    assert row["fwd_s"] == 1e-3 and row["bwd_s"] == 2e-3
    req = step_request(ff, table)
    assert req["assignment"][str(g)] == "rep_k:flash"
    assert {c for k, c in req["assignment"].items() if k != str(g)} \
        == {"rep"}
    # the simulator prices the flash row: the step with every op's plain
    # rows (attention's einsum) is the longer by the rows' difference
    flash_s, _ = predicted_step(ff, table)
    plain = {k: v for k, v in table.items() if not k.endswith(":flash")}
    einsum_s, _ = predicted_step(ff, plain)
    assert einsum_s - flash_s == pytest.approx((3e-3 + 6e-3)
                                               - (1e-3 + 2e-3), rel=0.05)


# ---- the roofline's element width -------------------------------------------

def _one_dense_report(dtype):
    from flexflow_tpu_torch.models import create_mlp
    from flexflow_tpu_torch.obs.roofline import roofline_report
    ff = create_mlp(batch_size=32, in_dim=256, hidden_dims=(), out_dim=512,
                    ff_config=P.FFConfig(batch_size=32), device="cpu")
    nodes, _, _ = ff._materialize_nodes()
    dense = [n for n in nodes if n.op.op_type.name == "LINEAR"][:1]
    return roofline_report(dense, CPU, repeats=1, include_bwd=False,
                           device="cpu", dtype=dtype), dense[0].op


def test_bf16_roofline_gives_the_corpus_its_parameter_bytes(monkeypatch):
    from flexflow_tpu_torch.costmodel.corpus import rows_from_roofline
    from flexflow_tpu_torch.search import profile
    monkeypatch.setattr(profile, "_MIN_DELTA_S", 0.002)
    report, op = _one_dense_report(torch.bfloat16)
    assert report["meta"] == {"dtype_size": 2.0}
    (row,) = rows_from_roofline(report, "roofline_bf16.json")
    want = float(op.params_elems()) * 2.0
    assert abs(row["param_bytes"] - want) <= 0.01 * want
    assert row["dtype_size"] == 2


def test_f32_roofline_reads_as_the_references(monkeypatch):
    from flexflow_tpu.costmodel.corpus import \
        rows_from_roofline as j_rows_from_roofline
    from flexflow_tpu_torch.costmodel.corpus import rows_from_roofline
    from flexflow_tpu_torch.search import profile
    monkeypatch.setattr(profile, "_MIN_DELTA_S", 0.002)
    report, op = _one_dense_report(torch.float32)
    assert report["meta"] == {"dtype_size": 4.0}
    payload = json.loads(json.dumps(report))
    got = rows_from_roofline(payload, "r.json")
    payload.pop("meta")  # the JAX package's reports carry no width
    assert rows_from_roofline(payload, "r.json") == got
    assert got == j_rows_from_roofline(payload, "r.json")
    assert got[0]["param_bytes"] == pytest.approx(
        float(op.params_elems()) * 4.0)


# ---- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_both_clis_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CLIs plan the visible cards and "
                    "explain --measure-ops times the flash kernel")
    env = dict(os.environ, FFS_CALIBRATION_FILE=str(tmp_path / "n.json"))
    proc = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.scripts.fflint",
         "--model", "transformer", "--json"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["context"]["mesh_axes"] == {"data": 1}
    out = str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.scripts.explain",
         "--model", "transformer", "--budget", "2", "--measure-ops",
         "--out-dir", out],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr
    st = json.load(open(os.path.join(out, "SEARCH_TRACE.json")))
    att = [r["guid"] for r in st["corpus"]
           if r["type"] == "MULTIHEAD_ATTENTION"]
    m = st["measured_ops"]
    for g in att:
        assert m[f"{g}:fwd"] > 0 and m[f"{g}:fwd:flash"] > 0
        assert m[f"{g}:fwd"] != m[f"{g}:fwd:flash"]
