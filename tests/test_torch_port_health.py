"""PyTorch port: preemption-aware supervision, mirroring
``tests/test_runtime_health.py`` where the port has a counterpart.

``flexflow_tpu_torch/runtime_health.py`` and ``ckpt/faults.py``: the
``FFS_FAULT`` grammar (parsed by both packages alike), the watchdog and
the preemption handler on a fake clock (no real multi-second sleeps),
the supervisor's exit-code table and restart/backoff loop with a fake
runner, SIGTERM -> grace checkpoint -> ``PREEMPTED_EXIT`` -> bitwise
resume in one process through a real ``fit``, transient write errors
absorbed and exhausted ones surfaced, and the restore's read planner.
"""

import io
import os
import signal

import numpy as np
import pytest
import torch

from flexflow_tpu.ckpt import faults as j_faults
from flexflow_tpu.ckpt.sharded import _select_rows as j_select_rows
import flexflow_tpu_torch as P
from flexflow_tpu_torch.ckpt import faults
from flexflow_tpu_torch.ckpt import manifest as mf
from flexflow_tpu_torch.ckpt import (CheckpointManager, latest_complete,
                                     load_sharded, save_sharded,
                                     verify_step_dir)
from flexflow_tpu_torch.ckpt.sharded import _select_rows
from flexflow_tpu_torch.ffconst import ActiMode
from flexflow_tpu_torch.obs.registry import get_registry
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.runtime_health import (HUNG_EXIT, KILL_EXIT,
                                               PREEMPTED_EXIT, Preempted,
                                               PreemptionHandler,
                                               RuntimeHealth, Supervisor,
                                               Watchdog, classify_exit,
                                               dump_thread_stacks)
from flexflow_tpu.runtime_health import (HUNG_EXIT as J_HUNG,
                                         PREEMPTED_EXIT as J_PREEMPTED,
                                         classify_exit as j_classify)


def small_model(checkpoint_dir=None, grace=0.0, watchdog=0.0):
    cfg = P.FFConfig(batch_size=64, checkpoint_dir=checkpoint_dir)
    cfg.grace_window_s = grace
    cfg.watchdog_timeout_s = watchdog
    ff = P.FFModel(cfg, device="cpu")
    t = ff.create_tensor((64, 16))
    h = ff.dense(t, 32, activation=ActiMode.AC_MODE_RELU, name="h1")
    ff.softmax(ff.dense(h, 4, name="out"))
    ff.compile(AdamOptimizer(alpha=0.01, state_dtype=torch.bfloat16),
               P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def blobs(n=256, d=16, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, d) * 3
    y = rs.randint(0, classes, n)
    x = (centers[y] + rs.randn(n, d)).astype(np.float32)
    return x, y.astype(np.int32).reshape(-1, 1)


def set_fault(monkeypatch, spec):
    """Point FFS_FAULT at ``spec`` with a fresh plan (the parse cache
    memoizes per spec string, and a plan's one-shot state must not leak
    between tests)."""
    faults._CACHE.pop(spec, None)
    monkeypatch.setenv(faults.ENV, spec)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---- fault grammar: both packages parse alike ---------------------------------

SPECS = ["sigterm:1@step:5,hang:0@step:7,io_error:shards:3,kill_host:2@step:9",
         "io_error:a:b:2", "corrupt_shard:h1/kernel@step:4,slow_write:20"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_grammar_matches_the_reference(spec):
    ours, ref = faults._parse(spec), j_faults._parse(spec)
    for field in ("kills", "corrupts", "slow_write_s", "sigterms", "hangs",
                  "io_errors"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert faults.KILL_EXIT == j_faults.KILL_EXIT == KILL_EXIT == 77


@pytest.mark.parametrize("bad", [
    "sigterm:x@step:3", "sigterm:0@epoch:3", "hang:0", "io_error:shards",
    "io_error::2", "io_error:shards:0", "io_error:shards:x",
    "io_error:shards:2@step:1", "resurrect:0@step:1",
])
def test_fault_grammar_rejects(bad):
    with pytest.raises(ValueError, match="cannot parse fault"):
        faults._parse(bad)
    with pytest.raises(ValueError, match="cannot parse fault"):
        j_faults._parse(bad)


def test_io_check_budget_spends_and_exhausts():
    plan = faults._parse("io_error:shards:2")
    for _ in range(2):
        with pytest.raises(OSError):
            plan.io_check("/ckpt/step_1/shards_host0000.npz")
    plan.io_check("/ckpt/step_1/shards_host0000.npz")
    plan2 = faults._parse("io_error:shards:1")
    plan2.io_check("/ckpt/step_1/MANIFEST.json")
    assert plan2.io_errors == [["shards", 1]]


def test_unset_env_is_a_noop(monkeypatch):
    monkeypatch.delenv(faults.ENV, raising=False)
    assert faults.get_plan() is None
    faults.step_hook(3)
    faults.io_check("/x")


# ---- watchdog (fake clock) ----------------------------------------------------

def test_watchdog_unarmed_until_first_beat():
    clk = FakeClock()
    trips = []
    w = Watchdog(10.0, clock=clk, on_trip=lambda: trips.append(1))
    clk.advance(1000.0)
    assert not w.check() and w.seconds_since_beat() == 0.0
    w.beat("step 0")
    clk.advance(10.5)
    assert w.check() and trips == [1]


def test_watchdog_no_trip_within_timeout_and_beat_resets():
    clk = FakeClock()
    trips = []
    w = Watchdog(10.0, clock=clk, on_trip=lambda: trips.append(1))
    w.beat("step 0")
    clk.advance(9.0)
    assert not w.check()
    w.beat("step 3")
    clk.advance(9.0)
    assert not w.check() and not trips


def test_watchdog_trip_fires_once_counter_and_stacks(capsys):
    clk = FakeClock()
    trips = []
    reg = get_registry()
    before = reg.get("pwd/watchdog_trip")
    w = Watchdog(10.0, run_name="pwd", clock=clk,
                 on_trip=lambda: trips.append(1))
    w.beat("step 4")
    clk.advance(10.5)
    assert w.check() and w.tripped
    assert w.check()
    assert trips == [1]
    assert reg.get("pwd/watchdog_trip") - before == 1
    err = capsys.readouterr().err
    assert "no progress for" in err and "step 4" in err and "thread" in err


@pytest.mark.parametrize("fails", [False, True])
def test_watchdog_default_trip_finalizes_then_exits_hung(fails):
    clk = FakeClock()
    order = []

    def finalize():
        order.append("finalize")
        if fails:
            raise RuntimeError("finalizer broke")

    w = Watchdog(5.0, clock=clk, finalize_fn=finalize,
                 exit_fn=order.append)
    w.beat()
    clk.advance(6.0)
    assert w.check()
    assert order == ["finalize", HUNG_EXIT]


def test_watchdog_polling_thread_starts_and_stops():
    import threading
    tripped = threading.Event()
    w = Watchdog(0.15, on_trip=tripped.set, poll_interval_s=0.03)
    w.beat()
    w.start()
    assert tripped.wait(timeout=3.0)
    w.stop()


def test_dump_thread_stacks_lists_main():
    buf = io.StringIO()
    dump_thread_stacks(buf)
    assert "MainThread" in buf.getvalue()


# ---- preemption handler ---------------------------------------------------------

def test_request_sets_flag_and_counter():
    reg = get_registry()
    before = reg.get("ppre/preemption_signal")
    h = PreemptionHandler(grace_window_s=0.0, run_name="ppre")
    assert not h.should_stop()
    h.request_preempt("test")
    assert h.should_stop() and h.reason == "test"
    assert reg.get("ppre/preemption_signal") - before == 1
    h.request_preempt("again")
    assert h.should_stop()
    assert reg.get("ppre/preemption_signal") - before == 1


def test_signal_handler_only_raises_the_flag(monkeypatch):
    """The handler sets the flag and nothing else: the registry count
    and the notice wait for the step loop's poll."""
    reg = get_registry()
    before = reg.get("psig/preemption_signal")
    h = PreemptionHandler(grace_window_s=0.0, run_name="psig")
    monkeypatch.setattr(reg, "inc", lambda *a, **k: pytest.fail(
        "the signal handler touched the registry"))
    h._on_signal(signal.SIGTERM, None)
    assert h.preempted and h.reason == f"signal:{int(signal.SIGTERM)}"
    monkeypatch.undo()
    assert h.should_stop()
    assert reg.get("psig/preemption_signal") - before == 1


def test_maintenance_notice_polled_and_time_gated():
    clk = FakeClock()
    polls = []

    def notice():
        polls.append(clk.t)
        return len(polls) >= 2

    h = PreemptionHandler(grace_window_s=0.0, notice_fn=notice,
                          notice_poll_s=5.0, clock=clk)
    assert not h.should_stop() and polls == [0.0]
    clk.advance(1.0)
    assert not h.should_stop() and polls == [0.0]
    clk.advance(5.0)
    assert h.should_stop() and polls == [0.0, 6.0]
    assert h.reason == "maintenance_notice"


def test_second_signal_exits_immediately():
    codes = []
    h = PreemptionHandler(grace_window_s=0.0, exit_fn=codes.append)
    h._on_signal(15, None)
    assert h.preempted and not codes
    h._on_signal(15, None)
    assert codes == [PREEMPTED_EXIT]


def test_grace_deadline_enforced_and_cancellable():
    import threading
    fired = threading.Event()
    h = PreemptionHandler(grace_window_s=0.2,
                          exit_fn=lambda c: fired.set())
    h.request_preempt("test")
    assert fired.wait(timeout=3.0)
    cancelled = threading.Event()
    h2 = PreemptionHandler(grace_window_s=0.3,
                           exit_fn=lambda c: cancelled.set())
    h2.request_preempt("test")
    h2.uninstall()
    assert not cancelled.wait(timeout=0.6)


def test_runtime_health_step_done_raises_preempted():
    health = RuntimeHealth(grace_window_s=0.0, watchdog_timeout_s=0.0,
                           notice_fn=lambda: True, exit_fn=lambda c: None)
    try:
        with pytest.raises(Preempted) as ei:
            health.step_done(0)
        assert ei.value.code == PREEMPTED_EXIT
    finally:
        health.close()


# ---- supervisor ---------------------------------------------------------------

def test_exit_code_table_matches_the_reference():
    assert (PREEMPTED_EXIT, HUNG_EXIT) == (J_PREEMPTED, J_HUNG) == (78, 79)
    for code in (0, KILL_EXIT, PREEMPTED_EXIT, HUNG_EXIT, 1, 137, -9, None):
        assert classify_exit(code) == j_classify(code)
    assert [classify_exit(c) for c in (0, 77, 78, 79, 1, None)] == [
        "clean", "kill", "preempted", "hung", "crash", "crash"]


def test_restart_loop_resume_flag_fault_clear_backoff(tmp_path):
    codes = [HUNG_EXIT, PREEMPTED_EXIT, 0]
    calls = []

    def run(cmd, env):
        calls.append((list(cmd), dict(env)))
        return codes[len(calls) - 1]

    slept = []
    state = str(tmp_path / "SUPERVISOR.json")
    sup = Supervisor(["train", "--checkpoint-dir", "d"], max_restarts=3,
                     backoff_base_s=1.0, backoff_max_s=3.0, state_path=state,
                     env={"FFS_FAULT": "hang:0@step:3", "KEEP": "1"},
                     run_fn=run, sleep_fn=slept.append, clock=FakeClock())
    s = sup.run()
    assert s["final_outcome"] == "clean" and s["restarts"] == 2
    assert [h["outcome"] for h in s["history"]] == [
        "hung", "preempted", "clean"]
    assert calls[0][0] == ["train", "--checkpoint-dir", "d"]
    assert "FFS_FAULT" in calls[0][1]
    for cmd, env in calls[1:]:
        assert cmd[-1] == "--resume" and cmd.count("--resume") == 1
        assert "FFS_FAULT" not in env and env["KEEP"] == "1"
    assert slept == [1.0, 2.0]
    rec = mf.read_json(state)
    assert rec["restarts"] == 2 and rec["final_outcome"] == "clean"
    assert rec["outcomes"] == {"hung": 1, "preempted": 1, "clean": 1}


def test_budget_exhaustion_returns_last_code():
    sup = Supervisor(["train"], max_restarts=2, backoff_base_s=10.0,
                     backoff_max_s=15.0, env={},
                     run_fn=lambda cmd, env: KILL_EXIT,
                     sleep_fn=lambda s: None, clock=FakeClock())
    s = sup.run()
    assert s["attempts"] == 3 and s["final_outcome"] == "kill"
    assert s["final_code"] == KILL_EXIT
    assert sup.backoff_s(0) == 10.0 and sup.backoff_s(1) == 15.0


def test_goodput_folds_supervisor_downtime(tmp_path):
    x, y = blobs()
    ff = small_model()
    ff.fit(x, y, epochs=1, verbose=False)
    cdir = str(tmp_path)
    mf.atomic_write_json(os.path.join(cdir, mf.SUPERVISOR_NAME),
                         dict(restarts=2, downtime_s=40.0))
    mgr = CheckpointManager(ff, cdir, every=0, run_name="psupgp")
    mgr.finalize(elapsed_s=10.0, steps=4)
    g = get_registry().to_dict()["gauges"]
    assert g["psupgp/supervisor_restarts"] == 2.0
    assert g["psupgp/supervisor_downtime_s"] == 40.0
    assert g["psupgp/goodput_effective"] <= 10.0 / 50.0 + 1e-9


# ---- SIGTERM -> grace checkpoint -> bitwise resume, in one process -------------

def test_sigterm_cuts_grace_checkpoint_and_resume_is_bitwise(
        tmp_path, monkeypatch):
    x, y = blobs()
    cdir = str(tmp_path / "ck")
    set_fault(monkeypatch, "sigterm:0@step:2")
    ff = small_model(checkpoint_dir=cdir, grace=60.0)
    with pytest.raises(SystemExit) as ei:
        ff.fit(x, y, epochs=2, verbose=False)
    assert ei.value.code == PREEMPTED_EXIT
    monkeypatch.delenv(faults.ENV)
    step, sdir = latest_complete(cdir)
    assert step == 3
    rep = verify_step_dir(sdir)
    assert rep["complete"], rep["errors"]
    reg = get_registry().to_dict()
    assert reg["counters"]["fit/preemption_signal"] >= 1
    assert reg["gauges"]["fit/grace_checkpoint_s"] > 0
    owner = getattr(signal.getsignal(signal.SIGTERM), "__self__", None)
    assert not isinstance(owner, PreemptionHandler)
    ff2 = small_model(checkpoint_dir=cdir)
    ff2.fit(x, y, epochs=2, verbose=False, resume=True)
    ff3 = small_model()
    ff3.fit(x, y, epochs=2, verbose=False)
    # slot 3 ends epoch 0: both report its loss, then epoch 1's
    assert ff2.epoch_losses == ff3.epoch_losses
    for layer, sub in ff3.params.items():
        for name, t in sub.items():
            assert torch.equal(ff2.params[layer][name], t)
    for key in ("m", "v"):
        for layer, sub in ff3.opt_state[key].items():
            for name, t in sub.items():
                assert torch.equal(ff2.opt_state[key][layer][name]
                                   .view(torch.int16), t.view(torch.int16))
    assert int(ff2.opt_state["t"]) == int(ff3.opt_state["t"]) == 8


def test_kill_host_fault_exits_with_kill_exit(tmp_path):
    """``kill_host`` exits a child process hard after the named step slot,
    leaving the last checkpoint committed before it."""
    import subprocess
    import sys
    code = (
        "import numpy as np, torch\n"
        "import flexflow_tpu_torch as P\n"
        "from flexflow_tpu_torch.ffconst import ActiMode\n"
        "from flexflow_tpu_torch.optimizers import AdamOptimizer\n"
        "ff = P.FFModel(P.FFConfig(batch_size=64, checkpoint_async=False),"
        " device='cpu')\n"
        "t = ff.create_tensor((64, 16))\n"
        "ff.softmax(ff.dense(ff.dense(t, 32, name='h1'), 4, name='out'))\n"
        "ff.compile(AdamOptimizer(), "
        "P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY)\n"
        "rs = np.random.RandomState(0)\n"
        "x = rs.randn(256, 16).astype(np.float32)\n"
        "y = rs.randint(0, 4, (256, 1)).astype(np.int32)\n"
        f"ff.fit(x, y, epochs=2, verbose=False, checkpoint_dir={str(tmp_path)!r},"
        " checkpoint_every=2)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, FFS_FAULT="kill_host:0@step:4", PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == KILL_EXIT, out.stderr[-2000:]
    assert classify_exit(out.returncode) == "kill"
    # slots 0..4 ran (iteration 5); the last save was at iteration 4
    assert [(s, ok) for s, _, ok in
            __import__("flexflow_tpu_torch.ckpt", fromlist=["list_steps"])
            .list_steps(str(tmp_path))] == [(2, True), (4, True)]


# ---- transient and exhausted write errors ---------------------------------------

def test_exhausted_writer_error_surfaces_at_next_save_chained(
        tmp_path, monkeypatch):
    x, y = blobs()
    ff = small_model()
    ff.fit(x, y, epochs=1, verbose=False)
    monkeypatch.setenv("FFS_CKPT_IO_BACKOFF_S", "0.001")
    set_fault(monkeypatch, "io_error:shards_host:99")
    mgr = CheckpointManager(ff, str(tmp_path), every=1, async_write=True,
                            run_name="pioex")
    mgr.save(ff._iter)
    with pytest.raises(RuntimeError,
                       match="asynchronous checkpoint write") as ei:
        mgr.save(ff._iter + 1)
    assert isinstance(ei.value.__cause__, OSError)
    assert "FFS_FAULT injected" in str(ei.value.__cause__)
    monkeypatch.delenv(faults.ENV)
    mgr.finalize(elapsed_s=1.0, steps=2)


def test_sync_mode_raises_inline_with_cause(tmp_path, monkeypatch):
    x, y = blobs()
    ff = small_model()
    ff.fit(x, y, epochs=1, verbose=False)
    monkeypatch.setenv("FFS_CKPT_IO_BACKOFF_S", "0.001")
    set_fault(monkeypatch, "io_error:index_host:99")
    mgr = CheckpointManager(ff, str(tmp_path), every=1, async_write=False,
                            run_name="piosync")
    with pytest.raises(RuntimeError) as ei:
        mgr.save(ff._iter)
    assert isinstance(ei.value.__cause__, OSError)


def test_async_stall_is_the_snapshot_not_the_write(tmp_path, monkeypatch):
    """A slow writer (``slow_write``) does not stall the training thread:
    the stall gauge holds the snapshot, the write time the writer's."""
    x, y = blobs()
    set_fault(monkeypatch, "slow_write:300")
    ff = small_model()
    ff.fit(x, y, epochs=1, verbose=False, checkpoint_dir=str(tmp_path),
           checkpoint_every=4)
    obs = get_registry().to_dict()["observations"]
    assert obs["fit/ckpt_async_write_s"]["max"] >= 0.3
    assert obs["fit/ckpt_save_stall_s"]["min"] < 0.3


# ---- the restore's read planner (one process: whole boxes) ---------------------

def _rows(n_hosts, rows_per_host, cols, bytes_per_row):
    return [(f"shards_host{h:04d}.npz",
             dict(key=f"k::{h}", index=[[h * rows_per_host,
                                         (h + 1) * rows_per_host],
                                        [0, cols]],
                  crc32=0, bytes=bytes_per_row * rows_per_host))
            for h in range(n_hosts)]


@pytest.mark.parametrize("needed", [
    [[[16, 32], [0, 8]]],  # one host's share: read it, skip the rest
    [[[0, 64], [0, 8]]],   # the whole leaf over 4 boxes: full scan
    [[[0, 32], [0, 8]]],   # straddles two boxes: full scan
    None,                  # unknowable: full scan
])
def test_read_planner_matches_the_reference(needed):
    entries = _rows(4, 16, 8, 32)
    assert _select_rows(entries, needed) == j_select_rows(entries, needed)


def test_single_process_reads_all_and_counters_track(tmp_path):
    x, y = blobs()
    ff = small_model()
    ff.fit(x, y, epochs=1, verbose=False)
    save_sharded(str(tmp_path), ff)
    _, sdir = latest_complete(str(tmp_path))
    payload = verify_step_dir(sdir, deep=False)["payload_bytes"]
    reg = get_registry()
    before_read = reg.get("ckpt/restore_read_bytes")
    before_skip = reg.get("ckpt/restore_skipped_bytes")
    ff2 = small_model()
    assert load_sharded(str(tmp_path), ff2) == ff._iter
    assert reg.get("ckpt/restore_read_bytes") - before_read == payload
    assert reg.get("ckpt/restore_skipped_bytes") - before_skip == 0
