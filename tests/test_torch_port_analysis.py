"""PyTorch port, the fflint verifier (``flexflow_tpu_torch/analysis``)
against the JAX package's (``flexflow_tpu/analysis``).

Every test class of ``tests/test_analysis.py`` has its mirror here: the
same model is built in both packages from one layer counter (so op names
and guids agree), the same violation is seeded into both graphs, and the
two packages' ``LintReport.to_json()`` must be EQUAL — rule ids,
severities, messages, hints, anchors, the ``passes`` map and the
context. The JAX side compiles on conftest's 8 virtual CPU devices; the
port lays the same model out over 8 devices without executing it
(``analysis.orchestrator.plan_model``), the strategy compile would run.

Where the packages part by design, the test says so:
- the port has no manual parallel ops (``repartition``: ROADMAP.md Queue 1
  items 3 and 10), so its FFL104 case lints a stand-in node carrying the
  reference op's attributes;
- ``compile`` in the port lays out ONE device on the CPU (the JAX side
  8), so a compile-time report differs in ``mesh_axes`` only;
- ``lint_model(ff, hlo=True)`` compiles an XLA program in the JAX
  package; the port reads the step's NCCL census, ``{}`` on one device;
- the calibration pass audits the model's device platform and reads the
  port's calibration file (``CALIBRATION_GPU.json``);
- the priced-vs-emitted diff (``search/validate.py`` ``diff_collectives``,
  FFL201-203) says "the step emitted" where the JAX package says "XLA
  emitted": ``same`` compares the port's messages with that one phrase
  read as the reference's.
"""

import contextlib
import copy
import importlib.util
import json
import os
import types

import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import flexflow_tpu as J
from flexflow_tpu.analysis import LintContext as JLintContext
from flexflow_tpu.analysis import run_passes as j_run_passes
from flexflow_tpu.analysis.passes import calibration as jcal
from flexflow_tpu.analysis.passes import collectives as jcoll
from flexflow_tpu.analysis.passes import dtype as jdtype
from flexflow_tpu.analysis.passes import hygiene as jhyg
from flexflow_tpu.analysis.passes import layout as jlay
from flexflow_tpu.analysis.passes import multihost as jmh
from flexflow_tpu.analysis.passes import sharding as jsh
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.machine import make_mesh as j_make_mesh
from flexflow_tpu.models.mlp import create_mlp as j_create_mlp
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
from flexflow_tpu_torch.analysis import LintContext, lint_model, run_passes
from flexflow_tpu_torch.analysis.orchestrator import plan_model
from flexflow_tpu_torch.analysis.passes import calibration as pcal
from flexflow_tpu_torch.analysis.passes import collectives as pcoll
from flexflow_tpu_torch.analysis.passes import dtype as pdtype
from flexflow_tpu_torch.analysis.passes import hygiene as phyg
from flexflow_tpu_torch.analysis.passes import layout as play
from flexflow_tpu_torch.analysis.passes import multihost as pmh
from flexflow_tpu_torch.analysis.passes import sharding as psh
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.machine import make_mesh
from flexflow_tpu_torch.models.mlp import create_mlp
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)
from flexflow_tpu_torch.optimizers import SGDOptimizer
from flexflow_tpu_torch.tensor import Tensor as PTensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICES = 8  # conftest's virtual CPU devices: the JAX side's mesh
CAT = "SPARSE_CATEGORICAL_CROSSENTROPY"
MSE = "MEAN_SQUARED_ERROR_AVG_REDUCE"


# ---- building twins --------------------------------------------------------

def _starts():
    """Start both packages' layer and tensor counters at one value."""
    starts = []
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        s = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = s
        starts.append(s)
    return starts


@contextlib.contextmanager
def _counters_at(starts):
    """Build a port model from the counter values ``starts`` (the JAX
    twin's), then move both counters past everything built so far."""
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    yield
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


def _j_compile(ff, loss=CAT, **kw):
    ff.compile(J.SGDOptimizer(lr=0.01), getattr(J.LossType, loss), [], **kw)
    return ff


def _p_plan(ff, loss=CAT, devices=DEVICES, **kw):
    return plan_model(ff, devices, SGDOptimizer(lr=0.01),
                      getattr(P.LossType, loss), **kw)


def twins(jbuild, pbuild, loss=CAT, devices=DEVICES):
    """(JAX model compiled on the 8 CPU devices, port model planned over
    ``devices``): ``jbuild(J)`` / ``pbuild(P)`` build the same graph."""
    starts = _starts()
    jff = _j_compile(jbuild(), loss)
    with _counters_at(starts):
        pff = _p_plan(pbuild(), loss, devices)
    return jff, pff


def mlp_twins(batch=16, **cfg_kw):
    return twins(
        lambda: j_create_mlp(batch_size=batch, in_dim=64,
                             hidden_dims=(128, 128), out_dim=10,
                             ff_config=J.FFConfig(batch_size=batch,
                                                  **cfg_kw)),
        lambda: create_mlp(batch_size=batch, in_dim=64,
                           hidden_dims=(128, 128), out_dim=10,
                           ff_config=P.FFConfig(batch_size=batch, **cfg_kw),
                           device="cpu"))


@pytest.fixture(scope="module")
def _jax_mlp():
    """One compiled JAX small MLP for the module, and its counter starts;
    each test gets a fresh port twin and the JAX model restored."""
    starts = _starts()
    jff = _j_compile(j_create_mlp(batch_size=16, in_dim=64,
                                  hidden_dims=(128, 128), out_dim=10,
                                  ff_config=J.FFConfig(batch_size=16)))
    return jff, starts


@contextlib.contextmanager
def _restoring(ff):
    """Undo a test's edits of a shared JAX model's nodes and strategy."""
    saved = [(n, list(n.output_specs), dict(n.param_specs),
              copy.copy(getattr(n, "input_layouts", None)),
              copy.copy(getattr(n, "output_layouts", None)),
              n.op.name, list(n.op.input_shapes))
             for n in ff.executor.nodes]
    strategy, search_info = ff.strategy, ff.search_info
    try:
        yield
    finally:
        for n, os_, ps, il, ol, name, ishp in saved:
            n.output_specs, n.param_specs = os_, ps
            n.input_layouts, n.output_layouts = il, ol
            n.op.name, n.op.input_shapes = name, ishp
        ff.strategy, ff.search_info = strategy, search_info


@pytest.fixture
def mlp(_jax_mlp):
    """(JAX small MLP, its port twin planned over 8 devices)."""
    jff, starts = _jax_mlp
    with _counters_at(starts):
        pff = _p_plan(create_mlp(batch_size=16, in_dim=64,
                                 hidden_dims=(128, 128), out_dim=10,
                                 ff_config=P.FFConfig(batch_size=16),
                                 device="cpu"))
    with _restoring(jff):
        yield jff, pff


def jctx_of(ff, **kw):
    return JLintContext(nodes=ff.executor.nodes, mesh=ff.mesh,
                        strategy=ff.strategy, machine_spec=ff.machine_spec,
                        config=ff.config, final_ref=ff.executor.final_ref,
                        ff=ff, **kw)


def pctx_of(ff, **kw):
    return LintContext(nodes=ff.executor.nodes, mesh=ff.mesh,
                       strategy=ff.strategy, machine_spec=ff.machine_spec,
                       config=ff.config, final_ref=ff.executor.final_ref,
                       ff=ff, **kw)


def same(jrep, prep):
    """The two reports serialize identically; returns the JSON."""
    jdoc = jrep.to_json()
    pdoc = json.loads(json.dumps(prep.to_json()).replace(
        "the step emitted", "XLA emitted"))
    assert json.dumps(pdoc, sort_keys=True) == json.dumps(jdoc,
                                                          sort_keys=True), (
        json.dumps(jdoc, indent=1), json.dumps(pdoc, indent=1))
    return pdoc


def both(jff, pff, jpass, ppass, jkw=None, pkw=None):
    """Run one pass class (by module) over both packages' contexts and
    require equal reports; returns the port's report."""
    jrep = j_run_passes(jctx_of(jff, **(jkw or {})), [jpass()])
    prep = run_passes(pctx_of(pff, **(pkw or jkw or {})), [ppass()])
    same(jrep, prep)
    return prep


def rules(diags):
    return {d.rule for d in diags}


def _node(ff, type_name, k=0):
    return [n for n in ff.executor.nodes
            if n.op.op_type.name == type_name][k]


# ---- the mirrored classes --------------------------------------------------

class TestCleanModel:
    def test_no_diagnostics_on_clean_mlp(self, mlp):
        jff, pff = mlp
        prep = lint_model(pff)
        same(J.lint_model(jff), prep)
        assert not prep.errors and not prep.warnings, prep.format_human()
        assert prep.passes["sharding-legality"] == "ok"
        assert prep.passes["graph-hygiene"] == "ok"
        assert "skipped" in prep.passes["multihost-order"]
        assert "skipped" in prep.passes["calibration"]
        assert prep.context["mesh_axes"] == {"data": DEVICES}

    def test_report_json_shape(self, mlp):
        doc = same(J.lint_model(mlp[0]), lint_model(mlp[1]))
        assert set(doc) == {"context", "passes", "counts", "diagnostics"}
        assert doc["counts"] == dict(error=0, warning=0, info=0)
        json.dumps(doc)


class TestShardingLegality:
    def test_illegal_degree_fires_ffl101(self, mlp):
        jff, pff = mlp
        jff.executor.nodes[-2].output_specs[0] = JP(None, "data")
        pff.executor.nodes[-2].output_specs[0] = (None, "data")
        rep = both(jff, pff, jsh.ShardingLegalityPass,
                   psh.ShardingLegalityPass)
        hits = [d for d in rep.diagnostics if d.rule == "FFL101"]
        assert hits and hits[0].severity.value == "error"
        assert "not divisible" in hits[0].message
        assert hits[0].tensor == "out[0]"

    def test_unknown_axis_fires_ffl102(self, mlp):
        jff, pff = mlp
        jff.executor.nodes[0].output_specs[0] = JP("bogus")
        pff.executor.nodes[0].output_specs[0] = ("bogus",)
        rep = both(jff, pff, jsh.ShardingLegalityPass,
                   psh.ShardingLegalityPass)
        assert "FFL102" in rules(rep.errors)

    def test_duplicate_axis_fires_ffl105(self, mlp):
        jff, pff = mlp
        jff.executor.nodes[0].output_specs[0] = JP("data", "data")
        pff.executor.nodes[0].output_specs[0] = ("data", "data")
        rep = both(jff, pff, jsh.ShardingLegalityPass,
                   psh.ShardingLegalityPass)
        assert "FFL105" in rules(rep.errors)

    def test_repartition_axis_mismatch_fires_ffl104(self, mlp):
        # a repartition over 'model' on a data-only mesh: both packages
        # plan the same graph (the port has the parallel ops since its
        # multi-rank slice), and the FFL104 diagnostic must equal the JAX
        # model's
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=8), **dev)
            t = ff.create_tensor((8, 64))
            t = ff.repartition(t, dim=1, degree=4, axis="model")
            ff.dense(t, 10)
            return ff
        jff, pff = twins(lambda: build(J, {}),
                         lambda: build(P, dict(device="cpu")))
        jrep = j_run_passes(jctx_of(jff), [jsh.ShardingLegalityPass()])
        prep = run_passes(pctx_of(pff),
                          [psh.ShardingLegalityPass()])
        jhits = [d.to_json() for d in jrep.diagnostics if d.rule == "FFL104"]
        phits = [d.to_json() for d in prep.diagnostics if d.rule == "FFL104"]
        assert phits and phits == jhits
        assert phits[0]["severity"] == "error"
        assert "repartition" in phits[0]["message"]
        assert phits[0]["tensor"] == "out[0]"


class TestCollectiveInference:
    def test_dp_grad_sync_is_inferred(self, mlp):
        jff, pff = mlp
        jinf = jcoll.infer_strategy_collectives(jctx_of(jff))
        pinf = pcoll.infer_strategy_collectives(pctx_of(pff))
        assert pinf == jinf
        assert "allreduce" in pinf
        # at data degree 8 weight-update sharding engages, as in the JAX
        # package: the sync is a reduce-scatter plus the param gather
        assert any(s.endswith((":grad", ":grad-rs"))
                   for s in pinf["allreduce"]["sources"])
        assert pff.executor.weight_update_sharding \
            == jff.executor.weight_update_sharding

    def test_unpriced_inferred_collective_fires_ffl204(self, mlp):
        rep = both(*mlp, jcoll.CollectiveInferencePass,
                   pcoll.CollectiveInferencePass, jkw=dict(priced={}))
        hits = [d for d in rep.diagnostics if d.rule == "FFL204"]
        assert hits and hits[0].severity.value == "error"
        assert "priced none" in hits[0].message

    def test_unpriced_emitted_collective_fires_ffl201(self, mlp):
        rep = both(*mlp, jcoll.CollectiveInferencePass,
                   pcoll.CollectiveInferencePass,
                   jkw=dict(priced={"allreduce": 1e6},
                            emitted={"allreduce": 1e6, "ppermute": 5e6}))
        hits = [d for d in rep.diagnostics if d.rule == "FFL201"]
        assert hits and hits[0].severity.value == "error"
        assert "ppermute" in hits[0].message

    def test_phantom_priced_collective_fires_ffl203(self, mlp):
        rep = both(*mlp, jcoll.CollectiveInferencePass,
                   pcoll.CollectiveInferencePass,
                   jkw=dict(priced={"allreduce": 1e6, "ppermute": 8e6},
                            emitted={"allreduce": 1e6}))
        assert any(d.rule == "FFL203" and d.severity.value == "warning"
                   for d in rep.diagnostics)

    def test_replicated_strategy_infers_no_grad_sync(self, mlp):
        jff, pff = mlp
        for ff in (jff, pff):
            for node in ff.executor.nodes:
                node.output_specs = [None] * len(node.output_specs)
            ff.strategy = {}
        jinf = jcoll.infer_strategy_collectives(jctx_of(jff))
        pinf = pcoll.infer_strategy_collectives(pctx_of(pff))
        assert pinf == jinf and "allreduce" not in pinf

    def test_emitted_hlo_text_parses_as_the_reference(self, mlp):
        # an optimized-HLO text (a saved dump) reads the same in both
        jff, pff = mlp
        jrep = J.lint_model(jff, hlo=HLO_A)
        prep = lint_model(pff, hlo=HLO_A)
        same(jrep, prep)
        assert prep.context["hlo"] == "yes"

    def test_hlo_true_reads_the_steps_nccl_census(self):
        # the packages part here: the JAX package compiles an XLA step;
        # the port reads its step's NCCL census, {} on one device
        ff = create_mlp(batch_size=16, in_dim=64, hidden_dims=(128,),
                        out_dim=10, ff_config=P.FFConfig(batch_size=16),
                        device="cpu")
        ff.compile(SGDOptimizer(lr=0.01),
                   P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
        rep = lint_model(ff, hlo=True)
        assert rep.context["hlo"] == "yes"
        assert rep.passes["collective-inference"] == "ok"
        assert not rep.errors and not rep.warnings, rep.format_human()


class TestLayoutConsistency:
    def test_redundant_transpose_pair_fires_ffl301(self):
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=8), **dev)
            t = ff.create_tensor((8, 16, 32))
            t = ff.transpose(t, (0, 2, 1))
            t = ff.transpose(t, (0, 2, 1))
            ff.dense(t, 10)
            return ff
        jff, pff = twins(lambda: build(J, {}),
                         lambda: build(P, dict(device="cpu")))
        rep = both(jff, pff, jlay.LayoutConsistencyPass,
                   play.LayoutConsistencyPass)
        hits = [d for d in rep.diagnostics if d.rule == "FFL301"]
        assert hits and hits[0].severity.value == "warning"
        assert "identity" in hits[0].message

    def test_nhwc_on_rank2_fires_ffl303(self, mlp):
        jff, pff = mlp
        jff.executor.nodes[0].output_layouts = ["NHWC"]
        pff.executor.nodes[0].output_layouts = ["NHWC"]
        rep = both(jff, pff, jlay.LayoutConsistencyPass,
                   play.LayoutConsistencyPass)
        assert "FFL303" in rules(rep.errors)

    def test_broken_nhwc_chain_fires_ffl302(self):
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=8,
                                      conv_compute_layout="nhwc"), **dev)
            t = ff.create_tensor((8, 3, 16, 16))
            t = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1)
            t = ff.relu(t)
            t = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1)
            t = ff.flat(t)
            ff.dense(t, 10)
            return ff
        jff, pff = twins(lambda: build(J, {}),
                         lambda: build(P, dict(device="cpu")))
        # both layout passes ran the chain channels-last
        assert [getattr(n, "output_layouts", None)
                for n in pff.executor.nodes] == [
            getattr(n, "output_layouts", None) for n in jff.executor.nodes]
        for ff in (jff, pff):
            relu = _node(ff, "RELU")
            relu.input_layouts = ["NCHW"]
            relu.output_layouts = ["NCHW"]
        rep = both(jff, pff, jlay.LayoutConsistencyPass,
                   play.LayoutConsistencyPass)
        hits = [d for d in rep.diagnostics if d.rule == "FFL302"]
        assert hits and hits[0].severity.value == "warning"
        assert "NHWC chain" in hits[0].message


def _bn_twins():
    def build(M, dev):
        ff = M.FFModel(M.FFConfig(batch_size=8), **dev)
        t = ff.create_tensor((8, 4, 8, 8))
        t = ff.batch_norm(t, relu=False)
        t = ff.flat(t)
        ff.dense(t, 10)
        return ff
    return twins(lambda: build(J, {}), lambda: build(P, dict(device="cpu")))


class TestDtypePolicy:
    def test_bf16_statistics_fire_ffl401_and_402(self):
        import jax
        import jax.numpy as jnp
        import torch

        jff, pff = _bn_twins()
        jbn = _node(jff, "BATCHNORM").op
        pbn = _node(pff, "BATCHNORM").op

        def j_bad_forward(params, inputs, ctx, state=None):
            (x,) = inputs
            n = x.shape[0] * x.shape[2] * x.shape[3]
            zero = jnp.zeros((), x.dtype)
            mean = jax.lax.reduce(x, zero, jax.lax.add, (0, 2, 3)) / n
            var = jax.lax.reduce(
                (x - mean[None, :, None, None]) ** 2, zero, jax.lax.add,
                (0, 2, 3)) / n
            jbn._new_state = {"mean": mean, "var": var}
            return [(x - mean[None, :, None, None]) * jax.lax.rsqrt(
                var[None, :, None, None] + 1e-5)]

        def p_bad_forward(params, inputs, ctx, state):
            # the same seeded violation in torch: statistics summed with
            # a bf16 result and kept bf16 in the new state
            (x,) = inputs
            n = x.shape[0] * x.shape[2] * x.shape[3]
            mean = x.sum(dim=(0, 2, 3)) / n
            var = ((x - mean[None, :, None, None]) ** 2).sum(
                dim=(0, 2, 3)) / n
            y = (x - mean[None, :, None, None]) * torch.rsqrt(
                var[None, :, None, None] + 1e-5)
            return [y], {"mean": mean, "var": var}

        jbn.forward = j_bad_forward
        pbn.forward_with_state = p_bad_forward
        rep = both(jff, pff, jdtype.DtypePolicyPass, pdtype.DtypePolicyPass)
        assert {"FFL401", "FFL402"} <= rules(rep.errors), rep.format_human()

    def test_good_batchnorm_is_clean(self):
        jff, pff = _bn_twins()
        rep = both(jff, pff, jdtype.DtypePolicyPass, pdtype.DtypePolicyPass)
        assert not rep.diagnostics

    @pytest.mark.parametrize("norm", ["layer_norm", "rms_norm", "group_norm"])
    def test_shipped_norms_are_clean(self, norm):
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=8), **dev)
            if norm == "group_norm":
                t = ff.create_tensor((8, 4, 8, 8))
                t = ff.group_norm(t, 2)
                t = ff.flat(t)
            else:
                t = ff.create_tensor((8, 16, 32))
                t = getattr(ff, norm)(t)
            ff.dense(t, 10)
            return ff
        jff, pff = twins(lambda: build(J, {}),
                         lambda: build(P, dict(device="cpu")))
        rep = both(jff, pff, jdtype.DtypePolicyPass, pdtype.DtypePolicyPass)
        assert not rep.diagnostics

    def test_low_precision_output_cast_fires_ffl403(self):
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=8), **dev)
            t = ff.create_tensor((8, 64))
            t = ff.dense(t, 10)
            ff.cast(t, M.DataType.BFLOAT16)
            return ff
        jff, pff = twins(lambda: build(J, {}),
                         lambda: build(P, dict(device="cpu")))
        rep = both(jff, pff, jdtype.DtypePolicyPass, pdtype.DtypePolicyPass)
        hits = [d for d in rep.diagnostics if d.rule == "FFL403"]
        assert hits and hits[0].severity.value == "error"
        assert "truncated logits" in hits[0].message


HLO_A = """
ENTRY %main {
  %ar = f32[1024,8]{1,0} all-reduce(f32[1024,8]{1,0} %p0)
  %ag = f32[2048]{0} all-gather(f32[256]{0} %p1)
}
"""
HLO_B = """
ENTRY %main {
  %ag = f32[2048]{0} all-gather(f32[256]{0} %p1)
  %ar = f32[1024,8]{1,0} all-reduce(f32[1024,8]{1,0} %p0)
}
"""
HLO_C = """
ENTRY %main {
  %ar = f32[1024,8]{1,0} all-reduce(f32[1024,8]{1,0} %p0)
}
"""


def _multihost(mlp, texts, slices=None):
    kw = dict(hlo_per_host=texts)
    if slices is not None:
        kw["slice_of_host"] = slices
    jrep = j_run_passes(jctx_of(mlp[0], **kw), [jmh.MultihostOrderPass()])
    prep = run_passes(pctx_of(mlp[1], **kw), [pmh.MultihostOrderPass()])
    same(jrep, prep)
    return prep


class TestMultihostOrder:
    def test_sequence_extraction(self):
        seq = pmh.collective_sequence(HLO_A)
        assert seq == jmh.collective_sequence(HLO_A)
        assert [k for k, _ in seq] == ["all-reduce", "all-gather"]

    def test_matching_hosts_clean(self, mlp):
        rep = _multihost(mlp, [HLO_A, HLO_A])
        assert not rep.diagnostics
        assert rep.passes["multihost-order"] == "ok"

    def test_order_divergence_fires_ffl501(self, mlp):
        rep = _multihost(mlp, [HLO_A, HLO_B])
        hits = [d for d in rep.diagnostics if d.rule == "FFL501"]
        assert hits and "position 0" in hits[0].message

    def test_count_mismatch_fires_ffl502(self, mlp):
        rep = _multihost(mlp, [HLO_A, HLO_C])
        assert "FFL502" in rules(rep.errors)

    def test_single_program_skips(self, mlp):
        rep = _multihost(mlp, None)
        assert "skipped" in rep.passes["multihost-order"]


class TestMultihostOrderPerSlice:
    def test_clean_two_slices(self, mlp):
        rep = _multihost(mlp, [HLO_A] * 4, [0, 0, 1, 1])
        assert not rep.diagnostics
        assert rep.passes["multihost-order"] == "ok"

    def test_within_slice_divergence_names_the_slice(self, mlp):
        rep = _multihost(mlp, [HLO_A, HLO_A, HLO_A, HLO_B], [0, 0, 1, 1])
        hits = [d for d in rep.diagnostics if d.rule == "FFL501"]
        assert hits and "slice 1" in hits[0].message
        assert "FFL503" not in rules(rep.diagnostics)

    def test_within_slice_count_mismatch_fires_ffl502(self, mlp):
        rep = _multihost(mlp, [HLO_A, HLO_C, HLO_A, HLO_A], [0, 0, 1, 1])
        hits = [d for d in rep.diagnostics if d.rule == "FFL502"]
        assert hits and "slice 0" in hits[0].message

    def test_cross_slice_leader_divergence_fires_ffl503(self, mlp):
        rep = _multihost(mlp, [HLO_A, HLO_A, HLO_B, HLO_B], [0, 0, 1, 1])
        assert "FFL503" in rules(rep.errors)
        assert not {"FFL501", "FFL502"} & rules(rep.diagnostics)

    def test_cross_slice_count_mismatch_is_ffl503(self, mlp):
        rep = _multihost(mlp, [HLO_A, HLO_A, HLO_C, HLO_C], [0, 0, 1, 1])
        assert any(d.rule == "FFL503" and "collectives" in d.message
                   for d in rep.diagnostics)


class TestGraphHygiene:
    def test_dead_op_fires_ffl601(self):
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=8), **dev)
            t = ff.create_tensor((8, 64))
            head = ff.dense(t, 10, name="head")
            ff.dense(t, 32, name="dead_branch")
            ff.outputs = head
            return ff
        jff, pff = twins(lambda: build(J, {}),
                         lambda: build(P, dict(device="cpu")))
        rep = both(jff, pff, jhyg.GraphHygienePass, phyg.GraphHygienePass)
        hits = [d for d in rep.diagnostics if d.rule == "FFL601"]
        assert hits and hits[0].op == "dead_branch"
        assert "parameters" in hits[0].message

    def test_unused_input_fires_ffl602(self):
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=8), **dev)
            t = ff.create_tensor((8, 64), name="used")
            ff.create_tensor((8, 32), name="unused")
            ff.dense(t, 10)
            return ff
        jff, pff = twins(lambda: build(J, {}),
                         lambda: build(P, dict(device="cpu")))
        rep = both(jff, pff, jhyg.GraphHygienePass, phyg.GraphHygienePass)
        hits = [d for d in rep.diagnostics if d.rule == "FFL602"]
        assert hits and hits[0].tensor == "unused"

    def test_shape_contradiction_fires_ffl603(self, mlp):
        jff, pff = mlp
        jff.executor.nodes[1].op.input_shapes[0] = (16, 999)
        pff.executor.nodes[1].op.input_shapes[0] = (16, 999)
        rep = both(jff, pff, jhyg.GraphHygienePass, phyg.GraphHygienePass)
        assert "FFL603" in rules(rep.errors)

    def test_duplicate_name_fires_ffl604(self, mlp):
        for ff in mlp:
            ff.executor.nodes[1].op.name = ff.executor.nodes[0].op.name
        rep = both(*mlp, jhyg.GraphHygienePass, phyg.GraphHygienePass)
        assert "FFL604" in rules(rep.errors)


def _searched(ff, ctx_of):
    ctx = ctx_of(ff)
    ctx.searched = True
    return ctx


def _calibration(mlp):
    jrep = j_run_passes(_searched(mlp[0], jctx_of), [jcal.CalibrationPass()])
    prep = run_passes(_searched(mlp[1], pctx_of), [pcal.CalibrationPass()])
    same(jrep, prep)
    return prep


class TestCalibrationPass:
    def test_no_calibration_fires_ffl701(self, mlp, tmp_path, monkeypatch):
        monkeypatch.setenv("FFS_CALIBRATION_FILE",
                           str(tmp_path / "nonexistent.json"))
        rep = _calibration(mlp)
        assert any(d.rule == "FFL701" and d.severity.value == "warning"
                   for d in rep.diagnostics)

    def test_partial_corrections_fire_ffl702(self, mlp, tmp_path,
                                             monkeypatch):
        cal = dict(platform="cpu", op_corrections={
            "cpu": {"LINEAR": dict(factor=1.2, weight=1.0)}})
        p = tmp_path / "cal.json"
        p.write_text(json.dumps(cal))
        monkeypatch.setenv("FFS_CALIBRATION_FILE", str(p))
        rep = _calibration(mlp)
        hits = [d for d in rep.diagnostics if d.rule == "FFL702"]
        assert hits and "SOFTMAX" in hits[0].message

    def test_stale_platform_fires_ffl703(self, mlp, tmp_path, monkeypatch):
        cal = dict(platform="tpu", op_corrections={
            "tpu": {"LINEAR": dict(factor=1.2, weight=1.0),
                    "SOFTMAX": dict(factor=1.1, weight=1.0)}})
        p = tmp_path / "cal.json"
        p.write_text(json.dumps(cal))
        monkeypatch.setenv("FFS_CALIBRATION_FILE", str(p))
        rep = _calibration(mlp)
        assert "FFL703" in rules(rep.diagnostics)

    def test_heuristic_strategy_skips(self, mlp):
        rep = both(*mlp, jcal.CalibrationPass, pcal.CalibrationPass)
        assert "skipped" in rep.passes["calibration"]

    def test_gpu_calibration_file_on_the_card_platform(self, mlp, tmp_path,
                                                       monkeypatch):
        # the port's own half: the default file is CALIBRATION_GPU.json,
        # and a model on the card audits platform "gpu", so a file taken
        # there is not stale (FFL703 quiet) while a CPU-taken one is
        monkeypatch.delenv("FFS_CALIBRATION_FILE", raising=False)
        assert pcal.calibration_path().endswith("CALIBRATION_GPU.json")
        pff = mlp[1]
        p = tmp_path / "cal.json"
        monkeypatch.setenv("FFS_CALIBRATION_FILE", str(p))
        monkeypatch.setattr(pcal, "_current_platform", lambda ctx: "gpu")
        corr = {"LINEAR": dict(factor=1.2, weight=1.0),
                "SOFTMAX": dict(factor=1.1, weight=1.0)}
        p.write_text(json.dumps(dict(platform="gpu",
                                     op_corrections={"gpu": corr})))
        rep = run_passes(_searched(pff, pctx_of), [pcal.CalibrationPass()])
        assert rep.passes["calibration"] == "ok"
        assert "FFL703" not in rules(rep.diagnostics)
        p.write_text(json.dumps(dict(platform="cpu",
                                     op_corrections={"cpu": corr})))
        rep = run_passes(_searched(pff, pctx_of), [pcal.CalibrationPass()])
        assert "FFL703" in rules(rep.diagnostics)


class TestDriftCorrections:
    def _reference_calibrate(self):
        spec = importlib.util.spec_from_file_location(
            "calibrate", os.path.join(REPO, "scripts", "calibrate.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def test_derive_op_corrections_weights_by_share(self):
        from flexflow_tpu_torch.scripts import calibrate as pcalib
        rep = dict(
            header=dict(platform="cpu"),
            predicted=dict(total_s=0.01),
            measured=dict(step_s=0.02),
            per_op=[dict(type="LINEAR", sharded_s=0.008),
                    dict(type="SOFTMAX", sharded_s=0.002)])
        corr = pcalib.derive_op_corrections([rep])
        assert corr == self._reference_calibrate().derive_op_corrections(
            [rep])
        assert corr["cpu"]["LINEAR"]["factor"] == pytest.approx(2.0)
        assert corr["cpu"]["LINEAR"]["weight"] == pytest.approx(0.8)

    def test_derive_buckets_platforms_separately(self):
        from flexflow_tpu_torch.scripts import calibrate as pcalib
        cpu = dict(header=dict(platform="cpu"),
                   predicted=dict(total_s=0.01),
                   measured=dict(step_s=0.04),
                   per_op=[dict(type="LINEAR", sharded_s=0.01)])
        gpu = dict(header=dict(platform="gpu"),
                   predicted=dict(total_s=0.01),
                   measured=dict(step_s=0.011),
                   per_op=[dict(type="LINEAR", sharded_s=0.01)])
        corr = pcalib.derive_op_corrections([cpu, gpu])
        assert corr == self._reference_calibrate().derive_op_corrections(
            [cpu, gpu])
        assert corr["cpu"]["LINEAR"]["factor"] == pytest.approx(4.0)
        assert corr["gpu"]["LINEAR"]["factor"] == pytest.approx(1.1)

    def test_corrections_scale_measured_tables(self, mlp, tmp_path,
                                               monkeypatch):
        from flexflow_tpu.search.profile import \
            apply_drift_corrections as j_apply
        from flexflow_tpu_torch.search.profile import apply_drift_corrections
        p = tmp_path / "cal.json"
        p.write_text(json.dumps(dict(op_corrections={
            "cpu": {"LINEAR": dict(factor=3.0, weight=1.0)}})))
        monkeypatch.setenv("FFS_CALIBRATION_FILE", str(p))
        jff, pff = mlp
        guid = _node(pff, "LINEAR").op.guid
        measured = {f"{guid}:fwd": 1e-5, f"{guid}:bwd": 2e-5,
                    f"{guid}:fwd:flash": 4e-6}
        out = apply_drift_corrections(measured, pff.executor.nodes,
                                      platform="cpu")
        ref = j_apply(measured, jff.executor.nodes)
        assert out[f"{guid}:fwd"] == pytest.approx(3e-5) \
            == ref[f"{guid}:fwd"]
        assert out[f"{guid}:bwd"] == pytest.approx(6e-5) \
            == ref[f"{guid}:bwd"]
        # the port also scales a core's own rows (the JAX package has
        # none): the op type's factor prices every core of the op
        assert out[f"{guid}:fwd:flash"] == pytest.approx(1.2e-5)
        p.write_text(json.dumps(dict(op_corrections={
            "not-cpu": {"LINEAR": dict(factor=3.0, weight=1.0)}})))
        out2 = apply_drift_corrections(measured, pff.executor.nodes,
                                       platform="cpu")
        assert out2[f"{guid}:fwd"] == pytest.approx(1e-5)


class TestCompileWiring:
    def _strategy_file(self, tmp_path):
        strat = dict(version=1, mesh=dict(data=8), ops={
            "mlp_0": dict(choice=None, outputs=[["data"]], params={})})
        sf = tmp_path / "strategy.json"
        sf.write_text(json.dumps(strat))
        return str(sf)

    def test_lint_error_rejects_illegal_imported_strategy(self, tmp_path):
        sf = self._strategy_file(tmp_path)
        starts = _starts()
        jcfg = J.FFConfig(batch_size=6)
        jcfg.import_strategy_file = sf
        jff = j_create_mlp(batch_size=6, in_dim=64, hidden_dims=(128,),
                           out_dim=10, ff_config=jcfg)
        with pytest.raises(ValueError, match="fflint"):
            _j_compile(jff, lint="error")
        with _counters_at(starts):
            pcfg = P.FFConfig(batch_size=6)
            pcfg.import_strategy_file = sf
            pff = create_mlp(batch_size=6, in_dim=64, hidden_dims=(128,),
                             out_dim=10, ff_config=pcfg, device="cpu")
        # lint runs before the port refuses the 8-way mesh, and before
        # any parameter or optimizer state is allocated
        with pytest.raises(ValueError, match="fflint"):
            pff.compile(SGDOptimizer(lr=0.01),
                        P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [],
                        lint="error")
        assert pff.params == {} and pff.opt_state is None
        same(jff.lint_report, pff.lint_report)
        assert "FFL101" in rules(pff.lint_report.errors)

    def test_lint_warn_records_report(self):
        # the packages part here: the port's compile lays out one device
        # on the CPU, the JAX package 8 — the reports differ in the
        # context's mesh_axes only
        jff, pff = twins(
            lambda: j_create_mlp(batch_size=16, in_dim=64,
                                 hidden_dims=(128, 128), out_dim=10,
                                 ff_config=J.FFConfig(batch_size=16)),
            lambda: create_mlp(batch_size=16, in_dim=64,
                               hidden_dims=(128, 128), out_dim=10,
                               ff_config=P.FFConfig(batch_size=16),
                               device="cpu"), devices=1)
        jrep = J.lint_model(jff)
        starts = [pff.executor.nodes[0].op.guid]
        pff.compile(SGDOptimizer(lr=0.01),
                    P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [],
                    lint="warn")
        assert starts == [pff.executor.nodes[0].op.guid]
        prep = pff.lint_report
        assert prep is not None and not prep.has_errors()
        assert prep.context["mesh_axes"] == {"data": 1}
        jdoc, pdoc = jrep.to_json(), prep.to_json()
        jdoc["context"].pop("mesh_axes")
        pdoc["context"].pop("mesh_axes")
        assert pdoc == jdoc
        assert pff.params  # warn proceeds to allocation

    def test_lint_off_by_default(self):
        ff = create_mlp(batch_size=16, in_dim=64, hidden_dims=(128,),
                        out_dim=10, ff_config=P.FFConfig(batch_size=16),
                        device="cpu")
        ff.compile(SGDOptimizer(lr=0.01),
                   P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
        assert ff.lint_report is None

    def test_config_flag_parses(self):
        cfg = P.FFConfig()
        rest = cfg.parse_args(["--lint", "error", "--epochs", "2"])
        assert cfg.lint == "error" and cfg.epochs == 2 and not rest
        with pytest.raises(ValueError, match="--lint expects"):
            P.FFConfig().parse_args(["--lint", "nonsense"])
        ff = create_mlp(batch_size=16, in_dim=64, hidden_dims=(128,),
                        out_dim=10, ff_config=P.FFConfig(batch_size=16),
                        device="cpu")
        with pytest.raises(ValueError, match="lint expects"):
            ff.compile(SGDOptimizer(lr=0.01),
                       P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [],
                       lint="loud")


class TestPipelineLegality:
    _models = {}

    @classmethod
    def _transformer(cls, layers=4, batch=16, dropout=0.0):
        key = (layers, batch, dropout)
        if key not in cls._models:
            kw = dict(num_layers=layers, hidden_size=32, num_heads=2,
                      seq_length=8, batch_size=batch, dropout=dropout)
            starts = _starts()
            jff = j_create_transformer(JTransformerConfig(**kw),
                                       J.FFConfig(batch_size=batch))
            jff.compile(J.SGDOptimizer(lr=0.01),
                        J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
                        mesh=j_make_mesh(1, {"data": 1}))
            with _counters_at(starts):
                pff = create_transformer(TransformerConfig(**kw),
                                         P.FFConfig(batch_size=batch),
                                         device="cpu")
                _p_plan(pff, MSE, 1, mesh=make_mesh(1, {"data": 1}))
            cls._models[key] = (jff, pff)
        return cls._models[key]

    def _pipe(self, pair, axes, jconfig=None, pconfig=None):
        n = int(np.prod(list(axes.values())))
        jff, pff = pair
        jrep = j_run_passes(JLintContext(
            nodes=jff.executor.nodes, mesh=j_make_mesh(n, axes),
            strategy=jff.strategy, config=jconfig),
            [jsh.ShardingLegalityPass()])
        prep = run_passes(LintContext(
            nodes=pff.executor.nodes, mesh=make_mesh(n, axes),
            strategy=pff.strategy, config=pconfig),
            [psh.ShardingLegalityPass()])
        same(jrep, prep)
        return prep

    def test_indivisible_blocks_fire_ffl106(self):
        rep = self._pipe(self._transformer(layers=6), {"pipe": 4})
        assert "FFL106" in rules(rep.errors)

    def test_no_repeated_body_fires_ffl106(self):
        rep = self._pipe(mlp_twins(), {"pipe": 2, "data": 2})
        assert "FFL106" in rules(rep.errors)

    def test_dropout_in_blocks_fires_ffl107(self):
        rep = self._pipe(self._transformer(layers=2, dropout=0.1),
                         {"pipe": 2, "data": 2})
        assert "FFL107" in rules(rep.errors)

    def test_batch_indivisible_fires_ffl108(self):
        cfgs = [J.FFConfig(batch_size=16), P.FFConfig(batch_size=16)]
        for c in cfgs:
            c.pipeline_microbatches = 16
        rep = self._pipe(self._transformer(layers=6),
                         {"pipe": 2, "data": 2}, *cfgs)
        assert "FFL108" in rules(rep.errors)

    def test_legal_pipe_context_is_clean(self):
        cfgs = [J.FFConfig(batch_size=16), P.FFConfig(batch_size=16)]
        for c in cfgs:
            c.pipeline_microbatches = 4
        rep = self._pipe(self._transformer(layers=6),
                         {"pipe": 2, "data": 2}, *cfgs)
        assert not {"FFL106", "FFL107", "FFL108"} & rules(rep.errors)


class TestOrchestrator:
    def test_crashing_pass_reports_ffl000(self, mlp):
        class Boom:
            name = "boom"

            def run(self, ctx):
                raise RuntimeError("kaboom")

        jrep = j_run_passes(jctx_of(mlp[0]), [Boom()])
        prep = run_passes(pctx_of(mlp[1]), [Boom()])
        same(jrep, prep)
        assert "crashed" in prep.passes["boom"]
        assert "FFL000" in rules(prep.diagnostics)

    def test_errors_sort_before_warnings_in_json(self, mlp):
        jff, pff = mlp
        jff.executor.nodes[0].output_specs[0] = JP("bogus")
        pff.executor.nodes[0].output_specs[0] = ("bogus",)
        jrep = j_run_passes(jctx_of(jff), [jsh.ShardingLegalityPass(),
                                           jhyg.GraphHygienePass()])
        prep = run_passes(pctx_of(pff), [psh.ShardingLegalityPass(),
                                         phyg.GraphHygienePass()])
        doc = same(jrep, prep)
        sevs = [d["severity"] for d in doc["diagnostics"]]
        assert sevs == sorted(sevs, key=["error", "warning",
                                         "info"].index)

    def test_all_passes_and_exports_match_the_reference(self):
        import flexflow_tpu.analysis as ja
        import flexflow_tpu_torch.analysis as pa
        from flexflow_tpu.analysis.orchestrator import all_passes as jall
        from flexflow_tpu_torch.analysis.orchestrator import all_passes
        assert pa.__all__ == ja.__all__
        assert [p.name for p in all_passes()] == [p.name for p in jall()]
        assert P.lint_model is lint_model
        assert P.Severity is pa.Severity
        assert P.edge_reshard_table is pa.edge_reshard_table
