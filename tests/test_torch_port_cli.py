"""PyTorch port, the command-line tools (``flexflow_tpu_torch/scripts``).

Each tool against the JAX package's script of the same name on the same
inputs, on the CPU:
- ``costmodel train`` on ``tests/fixtures/costmodel``: the same corpus and
  model files; ``report --json``: the same report, with and without the
  per-run step accuracy of ``tests/fixtures/obs_report_dir``; a schema-v4
  row exits 3 in both;
- ``obs_report`` on ``tests/fixtures/obs_report_dir``: the same report
  and markdown;
- ``calibrate --ingest-drift`` of a port trace dir: the same calibration
  file as the reference's script writes in a copied repo (the reference
  writes its repo's ``CALIBRATION.json``); the port writes only where
  ``FFS_CALIBRATION_FILE`` points;
- ``roofline --device cpu`` at the tiny BERT-proxy: the rows' FLOPs and
  bytes equal the reference's counts on the same graph;
- ``ckpt_inspect`` on a port checkpoint, a corrupted one and an empty
  dir: the same JSON summary and exit codes (0, 1, 2) as the reference's;
- ``supervise`` over a child that exits 78 and then 0: the same
  ``SUPERVISOR.json`` fields as the reference's.
Every tool runs as ``python -m flexflow_tpu_torch.scripts.<name>``.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import flexflow_tpu_torch as P
from flexflow_tpu_torch.models import TransformerConfig, create_transformer
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.scripts import calibrate as pcalibrate
from flexflow_tpu_torch.scripts import ckpt_inspect as pinspect
from flexflow_tpu_torch.scripts import costmodel as pcostmodel
from flexflow_tpu_torch.scripts import obs_report as pobs
from flexflow_tpu_torch.scripts import roofline as proofline
from flexflow_tpu_torch.scripts import supervise as psupervise
from flexflow_tpu_torch.search import profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "costmodel")
OBS_DIR = os.path.join(REPO, "tests", "fixtures", "obs_report_dir")
SMALL = dict(num_layers=2, hidden_size=32, num_heads=2, seq_length=8,
             batch_size=4)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"port_cli_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_ref(mod, argv, monkeypatch):
    """The reference script's ``main`` on ``argv`` (it reads sys.argv)."""
    monkeypatch.setattr(sys, "argv", [mod.__file__] + list(argv))
    return mod.main()


# ---- costmodel ------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages' ``costmodel train`` on the fixtures."""
    tmp = tmp_path_factory.mktemp("cm")
    ref = _script("costmodel")
    with pytest.MonkeyPatch.context() as mp:
        assert _run_ref(ref, ["train", "--trace-dir", FIXTURES, "--corpus",
                              str(tmp / "jc.json"), "--out",
                              str(tmp / "jm.json")], mp) == 0
    assert pcostmodel.main(["train", "--trace-dir", FIXTURES, "--corpus",
                            str(tmp / "pc.json"), "--out",
                            str(tmp / "pm.json")]) == 0
    return tmp, ref


def test_costmodel_train_writes_the_same_files(trained):
    tmp, _ = trained
    for a, b in (("jc.json", "pc.json"), ("jm.json", "pm.json")):
        assert json.load(open(tmp / b)) == json.load(open(tmp / a))
    model = json.load(open(tmp / "pm.json"))
    assert model["platform"] == "cpu" and "LINEAR" in model["classes"]


@pytest.mark.parametrize("trace_dir", [None, OBS_DIR],
                         ids=["corpus", "trace_dir"])
def test_costmodel_report_json_matches(trained, trace_dir, capsys,
                                       monkeypatch):
    tmp, ref = trained
    argv = ["report", "--model", str(tmp / "jm.json"), "--corpus",
            str(tmp / "jc.json"), "--json"]
    if trace_dir:
        argv += ["--trace-dir", trace_dir]
    assert _run_ref(ref, argv, monkeypatch) == 0
    want = json.loads(capsys.readouterr().out)
    assert pcostmodel.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == want
    assert set(got["corpus_accuracy"]) >= {"LINEAR", "CONV2D"}
    if trace_dir:
        assert got["step_accuracy"] and got["step_accuracy"] == \
            want["step_accuracy"]


def test_costmodel_report_markdown(trained, capsys):
    tmp, _ = trained
    assert pcostmodel.main(["report", "--model", str(tmp / "pm.json"),
                            "--corpus", str(tmp / "pc.json")]) == 0
    out = capsys.readouterr().out
    assert "Simulator accuracy on the corpus" in out and "analytic" in out


def test_costmodel_schema_drift_exits_3(tmp_path, monkeypatch):
    src = json.load(open(os.path.join(
        FIXTURES, "mlp_b16_r00_host00.simtrace.json")))
    src["corpus_schema"] = 4
    (tmp_path / "x_r00_host00.simtrace.json").write_text(json.dumps(src))
    argv = ["train", "--trace-dir", str(tmp_path), "--corpus",
            str(tmp_path / "c.json"), "--out", str(tmp_path / "m.json")]
    assert _run_ref(_script("costmodel"), argv, monkeypatch) == 3
    assert pcostmodel.main(argv) == 3
    assert not (tmp_path / "m.json").exists()


def test_costmodel_runs_as_a_module(trained):
    tmp, _ = trained
    r = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.scripts.costmodel",
         "report", "--model", str(tmp / "pm.json"), "--corpus",
         str(tmp / "pc.json")], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert "Per-class coverage" in r.stdout


# ---- obs_report -----------------------------------------------------------------

def test_obs_report_matches(tmp_path):
    ref = _script("obs_report")
    want, got = ref.build_report(OBS_DIR), pobs.build_report(OBS_DIR)
    want.pop("generated_unix")
    got.pop("generated_unix")
    assert got == want and got["runs"]
    assert pobs.to_markdown(got) == ref.to_markdown(want)
    out = str(tmp_path / "r.json")
    md = str(tmp_path / "r.md")
    assert pobs.main([OBS_DIR, "--out", out, "--md", md]) == 0
    assert json.load(open(out))["runs"] == want["runs"]
    assert "Simulator accuracy" in open(md).read()
    assert pobs.main([]) == 2


# ---- calibrate --ingest-drift ------------------------------------------------------

@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("trace"))
    ff = create_transformer(TransformerConfig(**SMALL),
                            P.FFConfig(batch_size=4), device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-3),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    rs = np.random.RandomState(0)
    x = rs.randn(8, 8, 32).astype(np.float32)
    y = rs.randn(8, 8, 1).astype(np.float32)
    ff.fit(x, y, epochs=2, verbose=False, trace_dir=td)
    return td


def test_ingest_drift_matches_the_reference(port_trace, tmp_path,
                                            monkeypatch):
    ref = _script("calibrate")
    fake_repo = tmp_path / "repo"
    (fake_repo / "scripts").mkdir(parents=True)
    monkeypatch.setattr(ref.os.path, "abspath",
                        lambda p: str(fake_repo / "scripts" / "x.py"))
    assert ref.ingest_drift(port_trace) == 0
    want = json.load(open(fake_repo / "CALIBRATION.json"))
    monkeypatch.undo()
    out = tmp_path / "CALIBRATION_GPU.json"
    monkeypatch.setenv("FFS_CALIBRATION_FILE", str(out))
    before = sorted(os.listdir(REPO))
    assert pcalibrate.main(["--ingest-drift", port_trace]) == 0
    assert sorted(os.listdir(REPO)) == before
    got = json.load(open(out))
    # the reference's patched abspath names its fake repo as the dir
    for r in want["results"]:
        r.pop("trace_dir")
    assert [r.pop("trace_dir") for r in got["results"]] == [
        os.path.abspath(port_trace)]
    assert got == want
    rows = [r for r in got["results"] if r["source"] == "drift_report"]
    assert [r["model"] for r in rows] == ["fit"] and rows[0]["platform"] \
        == "cpu"
    assert "cpu" in got["op_corrections"]
    # re-ingesting the directory replaces its rows in place
    assert pcalibrate.main(["--ingest-drift", port_trace]) == 0
    again = json.load(open(out))["results"]
    assert len(again) == 1 and again[0]["actual_s"] == rows[0]["actual_s"]


def test_ingest_drift_of_an_empty_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("FFS_CALIBRATION_FILE", str(tmp_path / "c.json"))
    assert pcalibrate.main(["--ingest-drift", str(tmp_path)]) == 1
    assert not (tmp_path / "c.json").exists()


def test_calibrate_keeps_drift_rows_and_corrections(tmp_path, monkeypatch):
    """A sweep rewrites its own rows and keeps the file's drift rows and
    correction buckets (the quick CPU sweep of one model)."""
    path = tmp_path / "CALIBRATION_GPU.json"
    path.write_text(json.dumps(dict(
        results=[dict(model="fit", source="drift_report", ratio=0.5),
                 dict(model="mlp", mem_ratio=9.0)],
        op_corrections=dict(cpu={"LINEAR": dict(factor=2.0)}))))
    monkeypatch.setattr(profile, "_MIN_DELTA_S", 0.002)
    monkeypatch.setattr(profile, "_TRIAD_ELEMS", 1 << 16)
    monkeypatch.setattr(pcalibrate, "actual_step_time",
                        lambda ff, xs, y: 1e-3)
    sweep = pcalibrate.build_models
    monkeypatch.setattr(pcalibrate, "build_models", lambda quick, device: [
        m for m in sweep(quick, device) if m[0] == "mlp"])
    monkeypatch.setenv("FFS_CALIBRATION_FILE", str(path))
    rc = pcalibrate.main(["--device", "cpu"])
    assert rc == 1  # the gate needs the BERT-proxy
    cal = json.load(open(path))
    assert cal["platform"] == "cpu" and cal["quick"] is True
    assert [r["model"] for r in cal["results"]] == ["mlp", "fit"]
    assert cal["results"][0]["mem_ratio"] is None  # no allocator on the CPU
    assert cal["results"][0]["ops_measured"] == cal["results"][0][
        "ops_total"]
    assert cal["op_corrections"] == {"cpu": {"LINEAR": {"factor": 2.0}}}


# ---- roofline --------------------------------------------------------------------

def test_roofline_rows_count_the_references_flops_and_bytes(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    from flexflow_tpu.models.transformer import (
        TransformerConfig as JTransformerConfig,
        create_transformer as j_create_transformer)
    from flexflow_tpu.search.profile import op_io_bytes

    monkeypatch.setattr(profile, "_MIN_DELTA_S", 0.002)
    out = str(tmp_path / "rf")
    assert proofline.main(["--model", "bert", "--device", "cpu",
                           "--no-bwd", "--repeats", "1", "--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == "bert" and line["batch"] == 8
    rep = json.load(open(out + ".json"))
    assert rep["meta"]["platform"] == "cpu"
    assert rep["machine"]["chip"] == "cpu-sim"
    jff = j_create_transformer(JTransformerConfig(
        num_layers=2, hidden_size=128, num_heads=4, seq_length=64,
        batch_size=8))
    nodes, _, _ = jff._materialize_nodes()
    want = [(n.op.op_type.name, float(n.op.flops()), op_io_bytes(n.op, 4.0))
            for n in nodes]
    got = [(r["type"], r["flops"], r["bytes"]) for r in rep["rows"]]
    assert got == want
    assert all("fwd_s" in r for r in rep["rows"])
    assert os.path.exists(out + ".md")


# ---- ckpt_inspect ----------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    ff = create_transformer(TransformerConfig(**SMALL),
                            P.FFConfig(batch_size=4), device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-3),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    rs = np.random.RandomState(0)
    x = rs.randn(4, 8, 32).astype(np.float32)
    y = rs.randn(4, 8, 1).astype(np.float32)
    ff.fit(x, y, epochs=2, verbose=False, checkpoint_dir=str(d / "ok"),
           checkpoint_every=1)
    return str(d / "ok")


def _inspect_both(path, capsys):
    ref = _script("ckpt_inspect")
    rc_want = ref.main([path, "--json"])
    want = json.loads(capsys.readouterr().out)
    rc_got = pinspect.main([path, "--json"])
    got = json.loads(capsys.readouterr().out)
    return rc_want, want, rc_got, got


def test_ckpt_inspect_a_port_checkpoint(checkpoint, capsys):
    rc_want, want, rc_got, got = _inspect_both(checkpoint, capsys)
    assert (rc_got, got) == (rc_want, want)
    assert rc_got == 0 and got["latest"]["verified"]
    assert got["latest"]["iteration"] == 2
    assert pinspect.main([checkpoint]) == 0
    text = capsys.readouterr().out
    assert "newest complete checkpoint" in text and "verified" in text


def test_ckpt_inspect_a_corrupted_checkpoint(checkpoint, tmp_path, capsys):
    bad = str(tmp_path / "bad")
    shutil.copytree(checkpoint, bad)
    newest = sorted(d for d in os.listdir(bad) if d.startswith("step_"))[-1]
    shard = next(os.path.join(bad, newest, f)
                 for f in sorted(os.listdir(os.path.join(bad, newest)))
                 if f.endswith(".bin") or f.startswith("shards"))
    mid = os.path.getsize(shard) // 2  # inside a leaf's bytes
    with open(shard, "r+b") as f:
        f.seek(mid)
        b = f.read(1)
        f.seek(mid)
        f.write(bytes([b[0] ^ 0xFF]))
    rc_want, want, rc_got, got = _inspect_both(bad, capsys)
    assert (rc_got, got) == (rc_want, want)
    assert rc_got == 1 and got["latest"]["errors"]


def test_ckpt_inspect_an_empty_dir(tmp_path, capsys):
    rc_want, want, rc_got, got = _inspect_both(str(tmp_path), capsys)
    assert (rc_got, got) == (rc_want, want) and rc_got == 2


# ---- supervise -------------------------------------------------------------------

CHILD = ("import sys; sys.exit(0 if '--resume' in sys.argv else 78)")


def _supervise(main, tmp, argv_pre):
    ckpt = tmp / "ckpts"
    ckpt.mkdir()
    rc = main(argv_pre + ["--max-restarts", "2", "--backoff-base", "0.01",
                          "--", sys.executable, "-c", CHILD,
                          "--checkpoint-dir", str(ckpt)])
    return rc, json.load(open(ckpt / "SUPERVISOR.json"))


def test_supervise_restarts_a_preempted_child(tmp_path, monkeypatch):
    ref = _script("supervise")
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    rc_want, want = _supervise(ref.main, tmp_path / "j", [])
    rc_got, got = _supervise(psupervise.main, tmp_path / "p", [])
    assert rc_got == rc_want == 0
    stable = ("final_code", "final_outcome", "attempts", "restarts",
              "outcomes")
    assert {k: got[k] for k in stable} == {k: want[k] for k in stable}
    assert got["final_outcome"] == "clean" and got["attempts"] == 2
    assert got["outcomes"] == {"preempted": 1, "clean": 1}
    assert [(h["code"], h["outcome"], h["resumed"])
            for h in got["history"]] == [
        (h["code"], h["outcome"], h["resumed"]) for h in want["history"]] \
        == [(78, "preempted", False), (0, "clean", True)]
    assert got["downtime_s"] > 0 and got["cmd"][-2] == "--checkpoint-dir"
