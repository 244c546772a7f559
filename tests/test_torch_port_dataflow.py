"""PyTorch port, the edge-level sharding dataflow
(``flexflow_tpu_torch/analysis/dataflow.py``) against the JAX package's.

Mirrors ``tests/test_dataflow.py``: the spec transition classifier, the
per-op required input specs, the per-edge reshard table, the tiny-batch
weight-movement rule, the edge rules FFL205 and FFL210-213, the
substitution hook ``verify_rewrite_dataflow``, and the census parity of
the weight-movement rule with the native simulator on searched ResNet
(organic) and seeded XDL at 8 devices. Each case seeds the same specs
into both packages' graphs (built from one layer counter) and requires
the same answer: transitions, requirement tuples and edge rows equal,
and the two collective-inference reports' JSON equal. A spec is the
port's tuple where the JAX package has a ``PartitionSpec``. The port has
no parallel ops (ROADMAP.md Queue 1 items 3 and 10): its
parallel-op-input case is a stand-in node, and says so.
"""

import contextlib
import copy
import json
import types

import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import flexflow_tpu as J
from flexflow_tpu.analysis import LintContext as JLintContext
from flexflow_tpu.analysis import classify_transition as j_classify
from flexflow_tpu.analysis import edge_reshard_table as j_table
from flexflow_tpu.analysis import required_input_specs as j_required
from flexflow_tpu.analysis import run_passes as j_run_passes
from flexflow_tpu.analysis import verify_rewrite_dataflow as j_verify
from flexflow_tpu.analysis import weight_movement_edges as j_wmoves
from flexflow_tpu.analysis.dataflow import _TableCtx as J_TableCtx
from flexflow_tpu.analysis.dataflow import _out_entries as j_out_entries
from flexflow_tpu.analysis.dataflow import _param_spec as j_param_spec
from flexflow_tpu.analysis.passes.collectives import \
    CollectiveInferencePass as JCollPass
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
from flexflow_tpu_torch.analysis import (LintContext, classify_transition,
                                         edge_reshard_table,
                                         required_input_specs, run_passes,
                                         verify_rewrite_dataflow,
                                         weight_movement_edges)
from flexflow_tpu_torch.analysis.dataflow import (ANY, _TableCtx,
                                                  _out_entries, _param_spec)
from flexflow_tpu_torch.analysis.orchestrator import plan_model
from flexflow_tpu_torch.analysis.passes.collectives import \
    CollectiveInferencePass
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.machine import Mesh
from flexflow_tpu_torch.optimizers import SGDOptimizer
from flexflow_tpu_torch.tensor import Tensor as PTensor

AXES = {"data": 2, "model": 4}
PRICED_ALL = {"allreduce": 1e9, "allgather": 1e9, "reshard": 1e9,
              "ppermute": 1e9}


def stub_mesh(**axes):
    """The JAX tests' stub mesh (axis names over a device array)."""
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 devices=np.zeros(tuple(axes.values())))


def _starts():
    starts = []
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        s = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = s
        starts.append(s)
    return starts


@contextlib.contextmanager
def _counters_at(starts):
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    yield
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


def twins(build, loss="SPARSE_CATEGORICAL_CROSSENTROPY", devices=8):
    """``build(pkg, dev_kw)`` in both packages from one counter: the JAX
    model compiled on conftest's 8 CPU devices, the port's planned over
    ``devices`` (``plan_model``)."""
    starts = _starts()
    jff = build(J, {})
    jff.compile(J.SGDOptimizer(lr=0.01), getattr(J.LossType, loss), [])
    with _counters_at(starts):
        pff = build(P, dict(device="cpu"))
        plan_model(pff, devices, SGDOptimizer(lr=0.01),
                   getattr(P.LossType, loss))
    return jff, pff


def _relu_chain(batch=64, width=128, n=3):
    def build(M, dev):
        ff = M.FFModel(M.FFConfig(batch_size=batch), **dev)
        t = ff.create_tensor((batch, width))
        for _ in range(n):
            t = ff.relu(t)
        ff.dense(t, 10)
        return ff
    return build


def relu_twins(**kw):
    return twins(_relu_chain(**kw))


@pytest.fixture(scope="module")
def _chain_pair():
    return relu_twins()


@pytest.fixture
def chain(_chain_pair):
    """(JAX relu chain, port relu chain): restored after each test."""
    jff, pff = _chain_pair
    saved = [[(n, list(n.output_specs), dict(n.param_specs))
              for n in ff.executor.nodes] for ff in (jff, pff)]
    strat = [(ff.strategy, dict(ff.strategy), ff.search_info)
             for ff in (jff, pff)]
    yield jff, pff
    for rows in saved:
        for n, os_, ps in rows:
            n.output_specs, n.param_specs = os_, ps
    for ff, (obj, items, si) in zip((jff, pff), strat):
        obj.clear()
        obj.update(items)
        ff.strategy, ff.search_info = obj, si


def relus(ff):
    return [n for n in ff.executor.nodes if n.op.op_type.name == "RELU"]


def _node(ff, name):
    return next(n for n in ff.executor.nodes if n.op.op_type.name == name)


def jctx_of(ff, mesh=None, **kw):
    return JLintContext(nodes=ff.executor.nodes,
                        mesh=mesh or stub_mesh(**AXES),
                        strategy=ff.strategy, machine_spec=ff.machine_spec,
                        config=ff.config, final_ref=ff.executor.final_ref,
                        ff=ff, **kw)


def pctx_of(ff, mesh=None, **kw):
    return LintContext(nodes=ff.executor.nodes, mesh=mesh or Mesh(AXES),
                       strategy=ff.strategy, machine_spec=ff.machine_spec,
                       config=ff.config, final_ref=ff.executor.final_ref,
                       ff=ff, **kw)


def reqs(ctx, node, out_entries, param_spec, required):
    return required(node, lambda n: out_entries(ctx, n, 0),
                    lambda n, name: param_spec(ctx, n, name))


def both_reqs(jff, pff, jnode, pnode, jmesh=None, pmesh=None):
    want = reqs(jctx_of(jff, jmesh), jnode, j_out_entries, j_param_spec,
                j_required)
    got = reqs(pctx_of(pff, pmesh), pnode, _out_entries, _param_spec,
               required_input_specs)
    assert got == want
    return got


def rows(table):
    return [e.to_json() for e in table]


def same_report(jrep, prep):
    jdoc = jrep.to_json()
    pdoc = json.loads(json.dumps(prep.to_json()).replace(
        "the step emitted", "XLA emitted"))
    assert pdoc == jdoc, (json.dumps(jdoc, indent=1),
                          json.dumps(pdoc, indent=1))
    return prep


def coll_both(jctx, pctx):
    return same_report(j_run_passes(jctx, [JCollPass()]),
                       run_passes(pctx, [CollectiveInferencePass()]))


class TestClassifyTransition:
    SHAPE = (64, 128)

    CASES = {
        "equal": ((("data", None), ("data", None)), AXES, 4.0),
        "size_one_axes": ((("model", None), (None, None)), {"model": 1},
                          4.0),
        "additional_slicing": (((None, None), ("data", None)), AXES, 4.0),
        "full_allgather": ((("model", None), (None, None)), AXES, 4.0),
        "partial_allgather": ((("data", "model"), ("data", None)), AXES,
                              4.0),
        "mixed_reshard": ((("model", None), (None, "model")), AXES, 4.0),
        "multislice_dcn": (((("slice", "data"), None), ("data", None)),
                           {"slice": 2, "data": 2}, 4.0),
        "element_width": ((("model", None), (None, None)), AXES, 2.0),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_transition_matches_the_reference(self, case):
        (src, dst), axes, elem = self.CASES[case]
        got = classify_transition(src, dst, self.SHAPE, axes, elem=elem)
        assert got == j_classify(src, dst, self.SHAPE, axes, elem=elem)
        expect = {"equal": None, "size_one_axes": None}
        if case in expect:
            assert got is None
        elif case == "additional_slicing":
            assert got["kind"] == "slice" and got["bytes"] == 0.0
        elif case == "multislice_dcn":
            assert got["fabric"] == "dcn" and got["axes"] == ("slice",)
        elif case == "element_width":
            assert got["bytes"] == 64 * 128 * 2.0
        else:
            assert got["kind"] in ("allgather", "reshard")


class TestRequiredInputSpecs:
    def test_linear_row_parallel_wants_contraction_sharded(self):
        def build(M, dev):
            from importlib import import_module
            mlp = import_module(f"{M.__name__}.models.mlp")
            return mlp.create_mlp(batch_size=16, in_dim=64,
                                  hidden_dims=(128,), out_dim=10,
                                  ff_config=M.FFConfig(batch_size=16), **dev)
        jff, pff = twins(build)
        jl, pl = _node(jff, "LINEAR"), _node(pff, "LINEAR")
        jl.output_specs[0] = JP("data", None)
        pl.output_specs[0] = ("data", None)
        jl.param_specs["kernel"] = pl.param_specs["kernel"] = ("model", None)
        assert both_reqs(jff, pff, jl, pl)[0] == ("data", "model")
        jl.param_specs["kernel"] = pl.param_specs["kernel"] = (None, "model")
        assert both_reqs(jff, pff, jl, pl)[0] == ("data", None)

    def test_conv_row_parallel_wants_in_channels_sharded(self):
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=8), **dev)
            t = ff.create_tensor((8, 4, 16, 16))
            t = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1)
            t = ff.flat(t)
            ff.dense(t, 10)
            return ff
        jff, pff = twins(build)
        jc, pc = _node(jff, "CONV2D"), _node(pff, "CONV2D")
        jc.output_specs[0] = JP("data")
        pc.output_specs[0] = ("data",)
        jc.param_specs["kernel"] = pc.param_specs["kernel"] = (
            None, "model", None, None)
        assert both_reqs(jff, pff, jc, pc)[0] == ("data", "model", None,
                                                  None)

    def test_transpose_permutes_the_requirement(self):
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=8), **dev)
            t = ff.create_tensor((8, 16, 32))
            t = ff.transpose(t, (0, 2, 1))
            t = ff.flat(t)
            ff.dense(t, 10)
            return ff
        jff, pff = twins(build)
        jt, pt = _node(jff, "TRANSPOSE"), _node(pff, "TRANSPOSE")
        jt.output_specs[0] = JP("data", "model", None)
        pt.output_specs[0] = ("data", "model", None)
        assert both_reqs(jff, pff, jt, pt)[0] == ("data", None, "model")

    def test_flat_transfers_the_leading_dim_only(self):
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=8), **dev)
            t = ff.create_tensor((8, 4, 16, 16))
            t = ff.flat(t)
            ff.dense(t, 10)
            return ff
        jff, pff = twins(build)
        jf, pf = _node(jff, "FLAT"), _node(pff, "FLAT")
        jf.output_specs[0] = JP("data", "model")
        pf.output_specs[0] = ("data", "model")
        assert both_reqs(jff, pff, jf, pf)[0] == ("data", None, None, None)

    def test_concat_drops_the_seam_axis(self):
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=8), **dev)
            a = ff.create_tensor((8, 32))
            b = ff.create_tensor((8, 32))
            t = ff.concat([a, b], axis=1)
            ff.dense(t, 10)
            return ff
        jff, pff = twins(build)
        jc, pc = _node(jff, "CONCAT"), _node(pff, "CONCAT")
        jc.output_specs[0] = JP("data", "model")
        pc.output_specs[0] = ("data", "model")
        assert both_reqs(jff, pff, jc, pc) == [("data", None)] * 2

    def test_attention_follows_batch_and_seq(self):
        def build(M, dev):
            from importlib import import_module
            tr = import_module(f"{M.__name__}.models.transformer")
            return tr.create_transformer(
                tr.TransformerConfig(num_layers=1, hidden_size=32,
                                     num_heads=2, seq_length=16,
                                     batch_size=8),
                M.FFConfig(batch_size=8), **dev)
        jff, pff = twins(build, loss="MEAN_SQUARED_ERROR_AVG_REDUCE")
        ja = _node(jff, "MULTIHEAD_ATTENTION")
        pa = _node(pff, "MULTIHEAD_ATTENTION")
        ja.output_specs[0] = JP("data", "seq", None)
        pa.output_specs[0] = ("data", "seq", None)
        got = both_reqs(jff, pff, ja, pa,
                        jmesh=stub_mesh(data=2, seq=2, model=2),
                        pmesh=Mesh(dict(data=2, seq=2, model=2)))
        for req in got:
            assert req[0] == "data" and req[1] == "seq"
            assert all(e is None for e in req[2:])

    def test_parallel_op_inputs_accept_anything(self):
        # the packages part here: the port has no parallel ops (ROADMAP.md
        # Queue 1 items 3 and 10); a stand-in node with the reference
        # repartition's attributes must accept any layout, as it does
        jff = J.FFModel(J.FFConfig(batch_size=8))
        t = jff.create_tensor((8, 64))
        t = jff.repartition(t, dim=0, degree=8, axis="data")
        jff.dense(t, 10)
        jff.compile(J.SGDOptimizer(lr=0.01),
                    J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
        jpar = next(n for n in jff.executor.nodes
                    if getattr(n.op, "is_parallel_op", False))
        want = reqs(jctx_of(jff), jpar, j_out_entries, j_param_spec,
                    j_required)
        op = types.SimpleNamespace(
            op_type=P.OperatorType.REPARTITION, is_parallel_op=True,
            guid=jpar.op.guid, input_shapes=list(jpar.op.input_shapes),
            output_shapes=list(jpar.op.output_shapes))
        node = types.SimpleNamespace(op=op, output_specs=[None],
                                     param_specs={})
        ctx = _TableCtx([], {}, AXES)
        got = reqs(ctx, node, _out_entries, _param_spec,
                   required_input_specs)
        assert len(got) == len(want) and all(r is ANY for r in got)


class TestEdgeTable:
    def test_clean_data_parallel_chain_has_no_moves(self, chain):
        jff, pff = chain
        table = edge_reshard_table(pctx_of(pff))
        assert rows(table) == rows(j_table(jctx_of(jff)))
        assert all(e.kind == "slice" or e.explicit for e in table)

    def test_seeded_disagreement_yields_one_edge_per_seam(self, chain):
        jff, pff = chain
        relus(jff)[0].output_specs[0] = JP("model", None)
        relus(pff)[0].output_specs[0] = ("model", None)
        table = edge_reshard_table(pctx_of(pff))
        assert rows(table) == rows(j_table(jctx_of(jff)))
        r = relus(pff)
        seams = [e for e in table if e.producer == r[0].op.name
                 and not e.explicit]
        assert len(seams) == 1
        assert seams[0].edge == (f"{r[0].op.name}.out[0] -> "
                                 f"{r[1].op.name}.in[0]")
        assert seams[0].to_json()["src_spec"] == "(model, ·)"

    def test_pipe_hop_is_explicit_ppermute(self, chain):
        out = []
        for ff, spec, T in ((chain[0], JP("model", None), J_TableCtx),
                            (chain[1], ("model", None), _TableCtx)):
            nodes = ff.executor.nodes
            r = relus(ff)
            r[0].output_specs[0] = spec
            cut = nodes.index(r[1])
            stub = types.SimpleNamespace(executor=types.SimpleNamespace(
                pb=types.SimpleNamespace(blocks=[
                    list(range(cut)), list(range(cut, len(nodes)))])))
            ctx = T(nodes, {}, {"data": 2, "model": 4, "pipe": 2}, ff=stub)
            table = j_table(ctx) if T is J_TableCtx else \
                edge_reshard_table(ctx)
            out.append(rows(table))
            hop = [e for e in table if e.producer == r[0].op.name]
            assert hop and hop[0].kind == "ppermute"
            assert hop[0].reason == "pipe-hop" and hop[0].explicit
        assert out[1] == out[0]

    def test_weight_movement_fires_on_tiny_batch_row_parallel(self):
        jff, pff = relu_twins(batch=16, width=64, n=1)
        jl, pl = _node(jff, "LINEAR"), _node(pff, "LINEAR")
        jl.output_specs[0] = JP("data", None)
        pl.output_specs[0] = ("data", None)
        jl.param_specs["kernel"] = pl.param_specs["kernel"] = ("model", None)
        moves = weight_movement_edges(pctx_of(pff))
        assert rows(moves) == rows(j_wmoves(jctx_of(jff)))
        assert [e.producer for e in moves] == [pl.op.name]
        assert moves[0].bytes == float(pl.op.params_elems()) * 4.0
        assert moves[0].reason == "tiny-batch weight movement"
        jl.output_specs[0] = JP("data", "model")
        pl.output_specs[0] = ("data", "model")
        assert not weight_movement_edges(pctx_of(pff))
        assert not j_wmoves(jctx_of(jff))


class TestEdgeRules:
    def test_unpriced_edge_without_simulator_fires_ffl205_error(self,
                                                                chain):
        jff, pff = chain
        relus(jff)[0].output_specs[0] = JP("model", None)
        relus(pff)[0].output_specs[0] = ("model", None)
        rep = coll_both(
            JLintContext(nodes=jff.executor.nodes, mesh=stub_mesh(**AXES),
                         strategy={}, ff=None),
            LintContext(nodes=pff.executor.nodes, mesh=Mesh(AXES),
                        strategy={}, ff=None))
        hits = [d for d in rep.diagnostics if d.rule == "FFL205"]
        assert hits and all(d.severity.value == "error" for d in hits)
        seam = next(d for d in hits if d.op == relus(pff)[1].op.name)
        assert seam.tensor == "in[0]" and "(model, ·)" in seam.message

    def test_priced_edge_keeps_ffl205_quiet(self, chain):
        jff, pff = chain
        relus(jff)[0].output_specs[0] = JP("model", None)
        relus(pff)[0].output_specs[0] = ("model", None)
        rep = coll_both(jctx_of(jff, priced=dict(PRICED_ALL)),
                        pctx_of(pff, priced=dict(PRICED_ALL)))
        assert not {"FFL205", "FFL210"} & {d.rule for d in rep.diagnostics}

    def test_zero_priced_edge_fires_ffl210_error(self, chain):
        jff, pff = chain
        relus(jff)[0].output_specs[0] = JP("model", None)
        relus(pff)[0].output_specs[0] = ("model", None)
        rep = coll_both(jctx_of(jff, priced={}), pctx_of(pff, priced={}))
        hits = [d for d in rep.diagnostics if d.rule == "FFL210"]
        assert hits and any(d.op == relus(pff)[1].op.name
                            and d.tensor == "in[0]" for d in hits)
        assert "unpriced edge reshard" in hits[0].message

    def test_round_trip_reshard_pair_fires_ffl211(self, chain):
        jff, pff = chain
        for ff, S in ((jff, JP), (pff, lambda *e: tuple(e))):
            r = relus(ff)
            r[0].output_specs[0] = S("model", None)
            r[1].output_specs[0] = S(None, "model")
            r[2].output_specs[0] = S("model", None)
        rep = coll_both(jctx_of(jff, priced=dict(PRICED_ALL)),
                        pctx_of(pff, priced=dict(PRICED_ALL)))
        hits = [d for d in rep.diagnostics if d.rule == "FFL211"]
        assert hits and hits[0].severity.value == "warning"
        assert "round trip" in hits[0].message
        assert hits[0].op == relus(pff)[1].op.name

    def test_replicated_materialization_fires_ffl212(self):
        jff, pff = relu_twins(batch=64, width=512)
        for ff, S in ((jff, JP), (pff, lambda *e: tuple(e))):
            r = relus(ff)
            r[0].output_specs[0] = None
            ff.strategy.pop(r[0].op.guid, None)
            r[1].output_specs[0] = S("data", None)
        rep = coll_both(jctx_of(jff, priced=dict(PRICED_ALL)),
                        pctx_of(pff, priced=dict(PRICED_ALL)))
        hits = [d for d in rep.diagnostics if d.rule == "FFL212"]
        assert hits and hits[0].op == relus(pff)[0].op.name
        assert hits[0].tensor == "out[0]"

    def test_recorded_rewrite_regression_fires_ffl213(self, chain):
        rv = dict(ok=False, findings=[dict(
            kind="reshard", pre_bytes=1 << 20, post_bytes=5 << 20,
            edge="fused_a_b.out[0] -> consumer.in[0]",
            src_spec="(data, ·)", dst_spec="(·, model)")])
        for ff in chain:
            ff.search_info = dict(rewrite_verification=copy.deepcopy(rv))
        rep = coll_both(jctx_of(chain[0], priced=dict(PRICED_ALL)),
                        pctx_of(chain[1], priced=dict(PRICED_ALL)))
        hits = [d for d in rep.diagnostics if d.rule == "FFL213"]
        assert hits and hits[0].severity.value == "error"
        assert "fused_a_b.out[0] -> consumer.in[0]" in hits[0].message

    def test_clean_rewrite_verification_stays_quiet(self, chain):
        for ff in chain:
            ff.search_info = dict(rewrite_verification=dict(ok=True,
                                                            findings=[]))
        rep = coll_both(jctx_of(chain[0], priced=dict(PRICED_ALL)),
                        pctx_of(chain[1], priced=dict(PRICED_ALL)))
        assert "FFL213" not in {d.rule for d in rep.diagnostics}


class TestVerifyRewrite:
    def test_equivalent_graphs_verify_ok(self):
        (jpre, ppre), (jpost, ppost) = relu_twins(), relu_twins()
        got = verify_rewrite_dataflow(ppre.executor.nodes,
                                      ppost.executor.nodes, {}, dict(AXES))
        assert got == j_verify(jpre.executor.nodes, jpost.executor.nodes,
                               {}, dict(AXES))
        assert got["ok"] and not got["findings"]

    def test_regressed_edge_map_is_flagged(self):
        (jpre, ppre), (jpost, ppost) = relu_twins(), relu_twins()
        for ff, S in ((jpost, JP), (ppost, lambda *e: tuple(e))):
            r = relus(ff)
            r[0].output_specs[0] = S("model", None)
            r[1].output_specs[0] = S(None, "model")
        got = verify_rewrite_dataflow(ppre.executor.nodes,
                                      ppost.executor.nodes, {}, dict(AXES))
        assert got == j_verify(jpre.executor.nodes, jpost.executor.nodes,
                               {}, dict(AXES))
        assert not got["ok"] and got["findings"][0]["kind"] == "reshard"

    def test_search_records_the_references_rewrite_verification(self):
        """Two linears on one input, summed: the substitution engine
        fuses them into one wide LINEAR and a SPLIT in both packages;
        graph_optimize records the same verification."""
        def build(M, dev):
            ff = M.FFModel(M.FFConfig(batch_size=64, search_budget=3,
                                      enable_parameter_parallel=True),
                           **dev)
            t = ff.create_tensor((64, 256))
            a = ff.dense(t, 128, name="qa")
            b = ff.dense(t, 128, name="qb")
            ff.outputs = ff.add(a, b)
            return ff
        jff, pff = twins(build, loss="MEAN_SQUARED_ERROR_AVG_REDUCE")
        for ff in (jff, pff):
            types_ = [n.op.op_type.name for n in ff.executor.nodes]
            assert types_.count("LINEAR") == 1 and "SPLIT" in types_
        prv = pff.search_info["rewrite_verification"]
        assert prv == jff.search_info["rewrite_verification"]
        assert prv["ok"] and "error" not in prv


class TestWeightMovementCensusParity:
    """The Python weight-movement rule, the JAX package's and the native
    simulator's weight gathers agree byte for byte on searched ResNet
    (row-parallel conv choices arise at budget 4) and on searched XDL
    with a row-parallel Linear seeded in, at 8 devices."""

    def _searched(self, name):
        from flexflow_tpu_torch.scripts import fflint as pcli
        import importlib.util
        import os
        spec = importlib.util.spec_from_file_location(
            "_ffs_fflint_port_dataflow", os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "scripts", "fflint.py"))
        jcli = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jcli)
        out = []
        starts = _starts()
        for pkg, cli in ((J, jcli), (P, pcli)):
            cfg = pkg.FFConfig()
            cfg.search_budget = 4
            cfg.enable_parameter_parallel = True
            cfg.enable_pipeline_parallel = False
            if pkg is J:
                ff, loss = cli.build_model(name, cfg)
                cli.compile_model(ff, loss)
            else:
                with _counters_at(starts):
                    ff, loss = cli.build_model(name, cfg, device="cpu")
                    cli.compile_model(ff, loss, num_devices=8)
            out.append(ff)
        return out

    @staticmethod
    def _native_wgather(ff, simulate):
        resp = simulate(ff)
        nodes = ff.executor.nodes
        out = {}
        for t in resp.get("tasks", []):
            if t.get("kind") != "comm" or t.get("collective") != "allgather":
                continue
            n = nodes[t["node"]]
            if n.op.op_type.name in ("LINEAR", "CONV2D"):
                out[n.op.name] = out.get(n.op.name, 0.0) + t["bytes"]
        return out

    @staticmethod
    def _moves(ff, Ctx, fn):
        ctx = Ctx(nodes=ff.executor.nodes, mesh=ff.mesh,
                  strategy=ff.strategy, machine_spec=ff.machine_spec,
                  config=ff.config, final_ref=ff.executor.final_ref, ff=ff)
        return {e.producer: e.bytes for e in fn(ctx)}

    def _check(self, jff, pff):
        from flexflow_tpu_torch.search.validate import simulate_strategy
        moves = self._moves(pff, LintContext, weight_movement_edges)
        assert moves == self._moves(jff, JLintContext, j_wmoves)
        native = self._native_wgather(pff, simulate_strategy)
        assert moves and set(moves) == set(native), (moves, native)
        for name, b in moves.items():
            assert b == pytest.approx(native[name]), (name, b, native)

    def test_searched_resnet_organic_parity(self):
        jff, pff = self._searched("resnet")
        assert dict(pff.mesh.shape) == dict(zip(jff.mesh.axis_names,
                                                jff.mesh.devices.shape))
        self._check(jff, pff)

    def test_seeded_xdl_row_parallel_parity(self):
        jff, pff = self._searched("xdl")
        model_deg = pff.mesh.shape.get("model", 1)
        assert model_deg == dict(zip(jff.mesh.axis_names,
                                     jff.mesh.devices.shape)).get("model", 1)
        if model_deg <= 1:
            pytest.skip("searched xdl mesh carries no model axis")
        seeded = []
        for ff, S in ((jff, JP), (pff, lambda *e: tuple(e))):
            lin = next(
                n for n in ff.executor.nodes
                if n.op.op_type.name == "LINEAR"
                and n.op.input_shapes[0][-1] % model_deg == 0
                and n.op.params_elems() > np.prod(n.op.output_shapes[0]))
            st = ff.strategy[lin.op.guid]
            st.choice = "dp_row"
            st.output_specs[0] = S("data", None)
            st.param_specs["kernel"] = S("model", None)
            lin.output_specs[0] = S("data", None)
            lin.param_specs["kernel"] = ("model", None)
            seeded.append(lin.op.name)
        assert seeded[0] == seeded[1]
        self._check(jff, pff)
