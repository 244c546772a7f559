"""Multi-process dryruns of checkpointing over a process group.

PyTorch counterpart of the checkpoint legs of
``flexflow_tpu/multihost_dryrun.py``: the fail-fast load, the elastic
kill-and-resume and the preemption legs, with the same phases, checks and
summary dicts. Where the JAX package starts one subprocess a host and
joins them through ``jax.distributed``, each leg here starts one
``torch.multiprocessing`` process a rank (spawned) and joins them in a
gloo group over a ``FileStore`` under the leg's temporary directory, one
rank a device, every world bounded by a timeout. The workers train the
dryrun transformer data-parallel on ``{"data": N}``, each rank feeding
its rows of the global batch (the executor cuts them), and run on the
card unless the caller asks for the CPU (``device="cpu"``); ranks that
share one card talk over gloo.

Run on the CPU:
``python -c "from flexflow_tpu_torch.multihost_dryrun import
run_elastic_dryrun; run_elastic_dryrun(device='cpu')"``.

The other legs of the JAX module (``run_dryrun``'s parity, tensor- and
ring-parallel legs, ``run_supervised_dryrun`` and the multi-slice legs)
are ROADMAP.md Queue 1 item 13 and raise here.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

#: a world's gloo timeout: a rank left waiting on a dead peer fails
#: inside it
_GROUP_TIMEOUT_S = 60.0


def _model_config(total_devices: int):
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(num_layers=1, hidden_size=32, num_heads=2,
                             seq_length=8, batch_size=2 * total_devices)


def _global_batch(cfg):
    rs = np.random.RandomState(0)
    x = rs.randn(cfg.batch_size, cfg.seq_length,
                 cfg.hidden_size).astype(np.float32)
    y = rs.randn(cfg.batch_size, cfg.seq_length, 1).astype(np.float32)
    return x, y


def _build(total_devices: int, device):
    """Compile the dryrun model data-parallel over ``total_devices``
    (the ranks of the group; one device without one)."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.ffconst import LossType
    from flexflow_tpu_torch.machine import make_mesh
    from flexflow_tpu_torch.models.transformer import create_transformer
    from flexflow_tpu_torch.optimizers import SGDOptimizer

    cfg = _model_config(total_devices)
    ff = create_transformer(cfg, FFConfig(batch_size=cfg.batch_size),
                            device=device)
    ff.compile(SGDOptimizer(lr=0.05),
               LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               mesh=make_mesh(total_devices, {"data": total_devices}))
    return ff


def _not_ported(name: str, item: str):
    raise NotImplementedError(
        f"{name}: this leg of the multi-process dryrun comes with ROADMAP.md "
        f"Queue 1 {item}; the port runs the checkpoint legs "
        f"(run_ckpt_failfast_dryrun, run_elastic_dryrun, "
        f"run_preemption_dryrun)")


def run_dryrun(*args, **kwargs):
    """The gradient-sync parity legs (data, tensor and ring parallel over
    hosts): ROADMAP.md Queue 1 item 13, its ring leg item 3.5."""
    _not_ported("run_dryrun", "item 13 (its ring leg: item 3.5)")


def run_supervised_dryrun(*args, **kwargs):
    """The supervised auto-restart legs: ROADMAP.md Queue 1 item 13."""
    _not_ported("run_supervised_dryrun", "item 13")


def run_multislice_dryrun(*args, **kwargs):
    """The multi-slice legs: ROADMAP.md Queue 1 item 13."""
    _not_ported("run_multislice_dryrun", "item 13")


# ---------------------------------------------------------------------------
# the worlds


def _rank_entry(entry: str, rank: int, world: int, store_path: str,
                device, env: Dict[str, Optional[str]], args) -> None:
    """One rank (a spawned process): take ``env``'s variables (None
    drops one), join the gloo group and run ``entry(rank, world, device,
    *args)``."""
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch import distributed

    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    # one thread a rank: the world's ranks share the host's cores
    torch.set_num_threads(1)
    distributed.initialize(store=dist.FileStore(store_path, world),
                           world_size=world, rank=rank, backend="gloo",
                           timeout_s=_GROUP_TIMEOUT_S)
    code = 1
    try:
        globals()[entry](rank, world, device, *args)
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    except BaseException:
        traceback.print_exc()
    try:
        dist.destroy_process_group()
    finally:
        exit_rank(code)


def exit_rank(code: int) -> None:
    """End a spawned rank with ``code``: the interpreter's exit, less its
    teardown. The threads it would join (a checkpoint writer finishing
    its commit) are joined, but no static object is destroyed, as a gloo
    thread still joinable then aborts the rank ("terminate called
    without an active exception")."""
    for t in threading.enumerate():
        if t is not threading.current_thread() and not t.daemon:
            t.join()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _worker_env(fault: Optional[str] = None) -> Dict[str, Optional[str]]:
    return {"FFS_FAULT": fault, "FFS_TRACE_DIR": None}


def _spawn(entry: str, world: int, root: str, device, args, env,
           timeout: float, tolerate_failures: bool,
           kill_grace: float = 30.0) -> List[Optional[int]]:
    """Start ``world`` ranks of ``entry`` and wait for them; returns the
    exit codes. Every world ends inside ``timeout``: a rank still
    running then is killed and the world raises ``TimeoutError``.
    ``tolerate_failures`` is the fault-injection mode: the first rank to
    die does not fail the world; its peers get ``kill_grace`` seconds to
    fail on the dead peer and are killed after."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = os.path.join(root, f"store_{entry}_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank_entry,
                         args=(entry, r, world, store, device, env, args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        first_death = None
        while time.monotonic() < deadline:
            codes = [p.exitcode for p in procs]
            if all(c is not None for c in codes):
                return codes
            if tolerate_failures and any(c is not None for c in codes):
                if first_death is None:
                    first_death = time.monotonic()
                elif time.monotonic() - first_death > kill_grace:
                    break  # the survivors are wedged on the dead peer
            time.sleep(0.05)
        if not tolerate_failures:
            raise TimeoutError(
                f"{entry}: the world of {world} ranks did not finish "
                f"within {timeout:.0f} s (exit codes "
                f"{[p.exitcode for p in procs]})")
        return [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.pid is None:
                continue  # never started
            if p.is_alive():
                p.kill()
            p.join()


def _resolve(device):
    """The workers' device: the card unless the caller names the CPU;
    raises where there is no card (before any process starts)."""
    from flexflow_tpu_torch.machine import resolve_device

    return str(resolve_device(device))


# ---------------------------------------------------------------------------
# the elastic legs: kill a rank mid-epoch, then resume from the last
# complete checkpoint on the same ranks (bit for bit) and on fewer (a
# re-searched strategy)


def _elastic_train_loop(ff, x, y, start: int, steps: int, mgr=None,
                        health=None):
    """The manual iteration protocol with the checkpoint-manager, fault
    and supervision seams ``fit`` uses, returning the per-step losses:
    the series the continuity checks compare bit for bit. ``health`` is
    fed after every step as ``fit``'s loop feeds it: a pending
    preemption raises ``Preempted`` after the step in flight."""
    from flexflow_tpu_torch.ckpt import faults

    losses = []
    ff.set_batch(x, y)
    for step in range(start, steps):
        ff.forward()
        ff.backward()
        ff.update()
        losses.append(float(ff._last_loss))
        faults.step_hook(step)
        if health is not None:
            health.step_done(step)
        if mgr is not None:
            if mgr.should_save(ff._iter):
                mgr.save(ff._iter)
            else:
                mgr.note_step(ff._iter)
    return losses


def elastic_worker_main(rank: int, world: int, device, out_path: str,
                        ckpt_dir: str, steps: int, every: int,
                        resume: int) -> None:
    """One rank of an elastic leg: train the dryrun model step by step
    with per-shard async checkpoints, honoring the ``FFS_FAULT`` plan
    (``kill_host`` mid-epoch), resuming from the newest complete
    checkpoint first when ``resume``."""
    ff = _build(world, device)
    x, y = _global_batch(_model_config(world))
    mgr = None
    start = 0
    if ckpt_dir:
        from flexflow_tpu_torch.ckpt import CheckpointManager
        mgr = CheckpointManager(ff, ckpt_dir, every=every, retain=3,
                                async_write=True, run_name="dryrun",
                                fs_timeout=60.0)
        if resume:
            start = mgr.resume(require=True)
    losses = _elastic_train_loop(ff, x, y, start, steps, mgr)
    if mgr is not None:
        mgr.finalize(elapsed_s=None, steps=None)
    np.savez(out_path[rank], losses=np.asarray(losses, np.float64),
             start=np.int64(start))


def smaller_worker_main(rank: int, world: int, device, out_path,
                        saved_ranks: int, step_dir: str, resume_step: int,
                        steps: int, budget: int) -> None:
    """One rank of the smaller world of phase D: compile with a search
    of ``budget`` in the group (the mesh of ``{"data": world}`` without
    one), restore ``step_dir`` onto the new boxes and train on."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.ffconst import LossType
    from flexflow_tpu_torch.machine import make_mesh
    from flexflow_tpu_torch.models.transformer import create_transformer
    from flexflow_tpu_torch.optimizers import SGDOptimizer

    # the model of the saving world: the same global batch and widths
    cfg = _model_config(saved_ranks)
    ff = create_transformer(
        cfg, FFConfig(batch_size=cfg.batch_size, search_budget=budget,
                      enable_parameter_parallel=world > 1), device=device)
    ff.compile(SGDOptimizer(lr=0.05),
               LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               mesh=None if budget else make_mesh(world, {"data": world}))
    it = ff.load_checkpoint(step_dir)
    if it != resume_step:
        raise AssertionError(f"smaller-mesh load restored iteration {it}, "
                             f"expected {resume_step}")
    x, y = _global_batch(cfg)
    losses = _elastic_train_loop(ff, x, y, resume_step, steps)
    np.savez(out_path[rank], losses=np.asarray(losses, np.float64),
             mesh_axes=np.asarray(list(ff.mesh.shape), dtype=str),
             mesh_sizes=np.asarray(list(ff.mesh.shape.values()), np.int64))


def failfast_worker_main(rank: int, world: int, device, out_path,
                         base_dir: str) -> None:
    """Every rank points at a rank-private checkpoint path (a filesystem
    not shared: only rank 0 sees what rank 0 wrote). The v1 and the v2
    load must raise the same actionable ``FileNotFoundError`` on every
    rank, promptly, and none may wait in a collective."""
    ff = _build(world, device)
    my_dir = os.path.join(base_dir, f"rank{rank}")
    os.makedirs(my_dir, exist_ok=True)
    # v1: a collective save whose files land only under rank 0's view
    v1_stem = os.path.join(my_dir, "ckpt_v1")
    ff.save_checkpoint(os.path.join(base_dir, "rank0", "ckpt_v1")
                       if rank == 0 else v1_stem + "_unwritten")
    results = {}
    try:
        ff.load_checkpoint(v1_stem)
        results["v1"] = "no error"
    except FileNotFoundError as e:
        results["v1"] = f"FileNotFoundError: {e}"
    # v2: rank 0 sees a real checkpoint, the others an empty directory
    from flexflow_tpu_torch.ckpt import load_sharded, save_sharded
    shared = os.path.join(base_dir, "shared_v2")
    save_sharded(shared, ff)  # every rank writes; genuinely shared
    probe = shared if rank == 0 else my_dir
    try:
        load_sharded(probe, ff)
        results["v2"] = "no error"
    except FileNotFoundError as e:
        results["v2"] = f"FileNotFoundError: {e}"
    np.savez(out_path[rank], **{k: np.str_(v) for k, v in results.items()})


def run_ckpt_failfast_dryrun(num_processes: int = 2, device=None,
                             timeout: float = 240) -> None:
    """The load of a checkpoint only some ranks can see fails fast on
    every rank: both formats raise ``FileNotFoundError`` naming the
    shared filesystem, and the world ends inside ``timeout`` (an
    unbounded wait in a collective is the fault this guards)."""
    device = _resolve(device)
    with tempfile.TemporaryDirectory() as td:
        outs = [os.path.join(td, f"ff{p}.npz") for p in range(num_processes)]
        rcs = _spawn("failfast_worker_main", num_processes, td, device,
                     (outs, os.path.join(td, "ckpts")), _worker_env(),
                     timeout, tolerate_failures=False)
        if any(rc != 0 for rc in rcs):
            raise RuntimeError(
                f"ckpt fail-fast dryrun: worker exit codes {rcs}")
        for p, out in enumerate(outs):
            got = {k: str(v) for k, v in np.load(out).items()}
            for fmt in ("v1", "v2"):
                if not got[fmt].startswith("FileNotFoundError"):
                    raise AssertionError(
                        f"worker {p} {fmt} load did not fail fast: "
                        f"{got[fmt]!r}")
                if "shared" not in got[fmt]:
                    raise AssertionError(
                        f"worker {p} {fmt} error is not actionable "
                        f"(no shared-filesystem hint): {got[fmt]!r}")
    print(f"ckpt fail-fast dryrun ok: {num_processes} ranks, both "
          f"formats raise actionable FileNotFoundError, no hang")


def run_elastic_dryrun(num_processes: int = 2, steps: int = 6,
                       every: int = 2, kill_step: int = 4, device=None,
                       timeout: float = 240) -> dict:
    """Kill-and-resume end to end.

    Phase A: an uninterrupted run of ``num_processes`` ranks records the
    reference losses. Phase B: the same run with
    ``FFS_FAULT=kill_host:<last rank>@step:<kill_step>`` and per-shard
    async checkpoints: the killed rank exits hard, its peers fail on it
    and are reaped, and the directory must hold a complete checkpoint
    and nothing readable beyond it. ``kill_step`` must leave a ``save``
    strictly between the first checkpointed iteration and the kill, so
    that earlier checkpoint has committed (``save`` joins the previous
    writer). Phase C: resume on the same ranks: the losses continue bit
    for bit. Phase D (in this process): resume on half the ranks:
    ``plan_resume`` says ``"research"``, the search (where the native
    core builds) picks a strategy for them, and the re-cut state trains
    on within reduction-order tolerance. Returns a summary dict."""
    from flexflow_tpu_torch.ckpt.faults import KILL_EXIT

    device = _resolve(device)
    kill_rank = num_processes - 1
    summary = {}
    with tempfile.TemporaryDirectory() as td:
        ckpt_dir = os.path.join(td, "ckpts")

        # ---- phase A: uninterrupted reference ---------------------------
        outs = [os.path.join(td, f"ref{p}.npz") for p in range(num_processes)]
        rcs = _spawn("elastic_worker_main", num_processes, td, device,
                     (outs, "", steps, every, 0), _worker_env(), timeout,
                     tolerate_failures=False)
        if any(rc != 0 for rc in rcs):
            raise RuntimeError(f"elastic dryrun reference: exit codes {rcs}")
        ref = np.load(outs[0])["losses"]
        if len(ref) != steps or not np.all(np.isfinite(ref)):
            raise AssertionError(f"reference losses malformed: {ref}")

        # ---- phase B: kill a rank mid-epoch -----------------------------
        outs_b = [os.path.join(td, f"fault{p}.npz")
                  for p in range(num_processes)]
        rcs = _spawn("elastic_worker_main", num_processes, td, device,
                     (outs_b, ckpt_dir, steps, every, 0),
                     _worker_env(f"kill_host:{kill_rank}@step:{kill_step}"),
                     timeout, tolerate_failures=True)
        if rcs[kill_rank] != KILL_EXIT:
            raise AssertionError(
                f"fault leg: rank {kill_rank} was meant to die with exit "
                f"{KILL_EXIT} at step {kill_step}, got exit codes {rcs}")
        from flexflow_tpu_torch.ckpt import latest_complete, verify_step_dir
        latest = latest_complete(ckpt_dir)
        if latest is None:
            raise AssertionError(
                "fault leg left no complete checkpoint — the pre-kill "
                "saves never committed")
        resume_step, step_dir = latest
        if resume_step > kill_step + 1:
            raise AssertionError(
                f"complete checkpoint at iteration {resume_step} claims "
                f"steps after the kill at step {kill_step}")
        rep = verify_step_dir(step_dir)
        if not rep["complete"]:
            raise AssertionError(
                f"latest checkpoint fails deep verification: "
                f"{rep['errors']}")
        summary["resume_step"] = resume_step

        # ---- phase C: resume on the same ranks, bit for bit -------------
        outs_c = [os.path.join(td, f"res{p}.npz")
                  for p in range(num_processes)]
        rcs = _spawn("elastic_worker_main", num_processes, td, device,
                     (outs_c, ckpt_dir, steps, every, 1), _worker_env(),
                     timeout, tolerate_failures=False)
        if any(rc != 0 for rc in rcs):
            raise RuntimeError(f"elastic dryrun resume: exit codes {rcs}")
        for p, out in enumerate(outs_c):
            got = np.load(out)
            start = int(got["start"])
            if start != resume_step:
                raise AssertionError(
                    f"worker {p} resumed at {start}, expected "
                    f"{resume_step}")
            cont, want = got["losses"], ref[start:]
            if not np.array_equal(cont, want):
                raise AssertionError(
                    f"worker {p}: resumed losses diverge from the "
                    f"uninterrupted run on the same ranks — not "
                    f"bit-identical\n  resumed {cont}\n  expected {want}")
        summary["same_mesh_bitwise"] = True

        # ---- phase D: resume on fewer ranks (re-searched) ---------------
        # phase C has since committed newer checkpoints into the same
        # directory: phase D restarts from the post-kill step dir
        n_small = max(1, num_processes // 2)
        from flexflow_tpu_torch.ckpt import load_manifest, plan_resume
        plan = plan_resume(load_manifest(step_dir), n_small)
        if plan["action"] != "research":
            raise AssertionError(
                f"plan_resume on {n_small}/{plan['saved_devices']} devices "
                f"should demand a re-search, got {plan}")
        from flexflow_tpu_torch.search.native import available
        budget = 6 if available() else 0
        outs_d = [os.path.join(td, f"small{p}.npz") for p in range(n_small)]
        rcs = _spawn("smaller_worker_main", n_small, td, device,
                     (outs_d, num_processes, step_dir, resume_step, steps,
                      budget),
                     _worker_env(), timeout, tolerate_failures=False)
        if any(rc != 0 for rc in rcs):
            raise RuntimeError(f"elastic dryrun smaller mesh: exit codes "
                               f"{rcs}")
        got = np.load(outs_d[0])
        cont = got["losses"]
        if not np.all(np.isfinite(cont)):
            raise AssertionError(
                f"smaller-mesh resume produced non-finite losses: {cont}")
        if not np.allclose(cont, ref[resume_step:], rtol=1e-3, atol=1e-5):
            raise AssertionError(
                f"smaller-mesh resumed losses diverged beyond reduction-"
                f"order tolerance\n  resumed {cont}\n  "
                f"expected {ref[resume_step:]}")
        summary["smaller_mesh"] = {str(k): int(v) for k, v in zip(
            got["mesh_axes"], got["mesh_sizes"])}
        summary["researched"] = bool(budget)
    print(f"elastic dryrun ok: {num_processes} ranks, killed rank "
          f"{kill_rank} at step {kill_step}, resumed from iteration "
          f"{summary['resume_step']}: same-ranks continuation bit-identical"
          f"; smaller mesh {summary['smaller_mesh']} "
          f"({'re-searched strategy' if summary['researched'] else 'heuristic strategy'}) "
          f"converges within tolerance")
    return summary


# ---------------------------------------------------------------------------
# the preemption leg: SIGTERM mid-epoch gives a complete grace-window
# checkpoint and a bit-identical resume


def preempted_worker_main(rank: int, world: int, device, out_path,
                          ckpt_dir: str, steps: int, every: int,
                          resume: int, grace: float) -> None:
    """The elastic worker under ``RuntimeHealth``: an ``FFS_FAULT``
    sigterm becomes a grace-window checkpoint through the manager (every
    rank reaches the commit) and the exit ``PREEMPTED_EXIT``."""
    from flexflow_tpu_torch.ckpt import CheckpointManager
    from flexflow_tpu_torch.runtime_health import (PREEMPTED_EXIT, Preempted,
                                                   RuntimeHealth)

    ff = _build(world, device)
    x, y = _global_batch(_model_config(world))
    health = RuntimeHealth(grace_window_s=grace, run_name="dryrun")
    mgr = CheckpointManager(ff, ckpt_dir, every=every, retain=3,
                            async_write=True, run_name="dryrun",
                            fs_timeout=60.0, heartbeat=health.heartbeat)
    start = mgr.resume(require=True) if resume else 0
    health.install()
    try:
        losses = _elastic_train_loop(ff, x, y, start, steps, mgr,
                                     health=health)
    except Preempted:
        # the grace path: the final checkpoint through the manager (every
        # rank writes its shards, rank 0 commits), then the exit code a
        # supervisor reads as "preempted"
        mgr.finalize(elapsed_s=None, steps=None)
        np.savez(out_path[rank], losses=np.asarray([], np.float64),
                 start=np.int64(start), preempted=np.int64(1))
        health.close()
        sys.exit(PREEMPTED_EXIT)
    mgr.finalize(elapsed_s=None, steps=None)
    health.close()
    np.savez(out_path[rank], losses=np.asarray(losses, np.float64),
             start=np.int64(start), preempted=np.int64(0))


def run_preemption_dryrun(num_processes: int = 2, steps: int = 6,
                          sigterm_step: int = 3, device=None,
                          timeout: float = 240) -> dict:
    """SIGTERM mid-epoch → grace-window checkpoint → bit-identical
    auto-resume, across ranks. Phase A records the uninterrupted
    losses; phase B delivers ``FFS_FAULT`` sigterm to every rank at
    ``sigterm_step``: each finishes the step in flight, the grace path
    cuts a checkpoint through the commit, and every rank exits
    ``PREEMPTED_EXIT``; phase C resumes on the same ranks and must
    continue bit for bit. Returns a summary dict."""
    from flexflow_tpu_torch.runtime_health import PREEMPTED_EXIT

    device = _resolve(device)
    summary = {}
    with tempfile.TemporaryDirectory() as td:
        ckpt_dir = os.path.join(td, "ckpts")

        # ---- phase A: uninterrupted reference ---------------------------
        outs = [os.path.join(td, f"ref{p}.npz") for p in range(num_processes)]
        rcs = _spawn("elastic_worker_main", num_processes, td, device,
                     (outs, "", steps, 0, 0), _worker_env(), timeout,
                     tolerate_failures=False)
        if any(rc != 0 for rc in rcs):
            raise RuntimeError(
                f"preemption dryrun reference: exit codes {rcs}")
        ref = np.load(outs[0])["losses"]
        if len(ref) != steps or not np.all(np.isfinite(ref)):
            raise AssertionError(f"reference losses malformed: {ref}")

        # ---- phase B: SIGTERM every rank mid-epoch ----------------------
        fault = ",".join(f"sigterm:{r}@step:{sigterm_step}"
                         for r in range(num_processes))
        outs_b = [os.path.join(td, f"pre{p}.npz")
                  for p in range(num_processes)]
        rcs = _spawn("preempted_worker_main", num_processes, td, device,
                     (outs_b, ckpt_dir, steps, 0, 0, 60.0),
                     _worker_env(fault), timeout, tolerate_failures=False)
        if rcs != [PREEMPTED_EXIT] * num_processes:
            raise AssertionError(
                f"preemption leg: every rank must exit PREEMPTED_EXIT "
                f"({PREEMPTED_EXIT}), got {rcs}")
        from flexflow_tpu_torch.ckpt import latest_complete, verify_step_dir
        latest = latest_complete(ckpt_dir)
        if latest is None:
            raise AssertionError(
                "preemption leg left no complete checkpoint — the grace "
                "window did not produce a committed save")
        resume_step, step_dir = latest
        if resume_step != sigterm_step + 1:
            raise AssertionError(
                f"grace checkpoint at iteration {resume_step}, expected "
                f"{sigterm_step + 1} (the post-in-flight-step state)")
        rep = verify_step_dir(step_dir)
        if not rep["complete"]:
            raise AssertionError(
                f"grace checkpoint fails deep verification: "
                f"{rep['errors']}")
        summary["resume_step"] = resume_step

        # ---- phase C: auto-resume, bit for bit --------------------------
        outs_c = [os.path.join(td, f"res{p}.npz")
                  for p in range(num_processes)]
        rcs = _spawn("preempted_worker_main", num_processes, td, device,
                     (outs_c, ckpt_dir, steps, 0, 1, 60.0), _worker_env(),
                     timeout, tolerate_failures=False)
        if any(rc != 0 for rc in rcs):
            raise RuntimeError(f"preemption dryrun resume: exit codes {rcs}")
        for p, out in enumerate(outs_c):
            got = np.load(out)
            start = int(got["start"])
            if start != resume_step:
                raise AssertionError(
                    f"worker {p} resumed at {start}, expected "
                    f"{resume_step}")
            cont, want = got["losses"], ref[start:]
            if not np.array_equal(cont, want):
                raise AssertionError(
                    f"worker {p}: post-preemption losses diverge from "
                    f"the uninterrupted run — not bit-identical\n  "
                    f"resumed {cont}\n  expected {want}")
        summary["bitwise"] = True
    print(f"preemption dryrun ok: {num_processes} ranks, SIGTERM at step "
          f"{sigterm_step} -> complete grace checkpoint at iteration "
          f"{summary['resume_step']}, resumed continuation bit-identical")
    return summary
