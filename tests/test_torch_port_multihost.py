"""PyTorch port, the checkpoint legs of the multi-process dryrun
(``flexflow_tpu_torch/multihost_dryrun.py``) on 2 gloo ranks on the CPU,
``tests/test_multihost.py``'s ``TestCheckpointFaultTolerance`` and
``TestPreemptionSupervision`` legs (there 2 JAX processes of one device
each):

- fail-fast: a checkpoint only rank 0 can see raises the same actionable
  ``FileNotFoundError`` on every rank, v1 and v2, inside the world's
  timeout;
- kill and resume: rank 1 killed at step 4 under per-shard async saves
  leaves a complete checkpoint and nothing readable beyond it; the
  resume on 2 ranks continues bit for bit, the resume on one re-searches
  and converges within reduction-order tolerance;
- preemption: SIGTERM to both ranks gives a grace checkpoint of the
  post-step state, every rank exits ``PREEMPTED_EXIT``, and the resume
  continues bit for bit.

Each leg spawns its own worlds (no module-level import touches JAX). The
legs the port leaves to later slices, and the refusals left on the
multi-rank path, raise naming their ROADMAP.md items.
"""

import types

import pytest
import torch

from flexflow_tpu_torch import multihost_dryrun as dryrun


def test_nonshared_fs_load_fails_fast_every_rank():
    dryrun.run_ckpt_failfast_dryrun(num_processes=2, device="cpu",
                                    timeout=120)


def test_kill_and_resume_elastic():
    summary = dryrun.run_elastic_dryrun(num_processes=2, device="cpu",
                                        timeout=120)
    # the JAX package's summary keys
    assert set(summary) == {"resume_step", "same_mesh_bitwise",
                            "smaller_mesh", "researched"}
    assert summary["same_mesh_bitwise"]
    # the newest save the kill at step 4 left complete: iteration 4 if
    # its writers finished before the kill, else iteration 2 (which the
    # save of 4 joined), as the JAX package's leg allows
    assert summary["resume_step"] in (2, 4)
    assert summary["smaller_mesh"] == {"data": 1}


def test_sigterm_grace_checkpoint_and_bitwise_resume():
    summary = dryrun.run_preemption_dryrun(num_processes=2, device="cpu",
                                           timeout=120)
    assert summary == {"resume_step": 4, "bitwise": True}


@pytest.mark.parametrize("leg,item", [
    ("run_dryrun", "Queue 1 item 13 (its ring leg: item 3.5)"),
    ("run_supervised_dryrun", "Queue 1 item 13"),
    ("run_multislice_dryrun", "Queue 1 item 13")])
def test_unported_legs_name_their_item(leg, item):
    with pytest.raises(NotImplementedError, match=item.replace(
            "(", r"\(").replace(")", r"\)").replace(".", r"\.")):
        getattr(dryrun, leg)()


def test_multi_rank_refusals_name_their_items():
    """``serve()`` over a mesh (item 3.3), experts over an 'expert' axis
    (3.4), a ring beside another axis (3.5), a 'pipe' axis (10)."""
    import flexflow_tpu_torch as P
    import flexflow_tpu_torch.ffconst as pconst
    from flexflow_tpu_torch.layer import Layer
    from flexflow_tpu_torch.machine import Mesh, local_ring_axis, make_mesh
    from flexflow_tpu_torch.ops import OpRegistry
    from flexflow_tpu_torch.ops.base import OpContext

    sharded = types.SimpleNamespace(
        executor=types.SimpleNamespace(multi_rank=True),
        mesh=make_mesh(4, {"data": 2, "model": 2}))
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 3\.3"):
        P.FFModel.serve(sharded)
    layer = Layer(pconst.OperatorType.EXPERTS, "ex", [])
    layer.properties.update(dict(n=4, k=1, hidden_size=3,
                                 expert_parallel="expert"))
    op = OpRegistry.create(layer, [(8, 4), (8, 4)])
    params = op.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 3\.4"):
        op.forward(params, [torch.zeros(8, 4), torch.full((8, 4), 0.25)],
                   OpContext(training=True,
                             mesh=make_mesh(4, {"expert": 4})))
    for axes, item in (({"expert": 2}, r"item 3\.4"),
                       ({"data": 2, "seq": 2}, r"item 3\.5"),
                       ({"data": 2, "pipe": 2}, "item 10")):
        with pytest.raises(NotImplementedError, match=item):
            local_ring_axis(Mesh(axes))
