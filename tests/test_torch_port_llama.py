"""PyTorch port, the decoder LM's ops and model against the JAX package.

The ops of ``create_llama`` (RMSNorm, Embedding in its three aggregation
modes, the elementwise kinds, RoPE with a position offset and the
attention op's KV-cache ``decode_forward``) are built in both packages
and fed the same numpy inputs and parameters made from a seed; then the
whole model at the reference's test size (vocab 256, hidden 64,
intermediate 128, 2 layers, 4 heads, 2 kv heads, batch 2, seq 16, and
kv heads 4 and 1 for grouped-query ratios 1 and 4), its weights carried
across with ``from_jax_params``. Everything is f32 on the CPU.

Tolerances: op forwards atol/rtol 1e-6, RoPE 1e-6 (f32; only the order
of the sums and the libm of sin/cos differ); ``decode_forward`` 1e-5 (an
attention's two contractions and a softmax in f32); ``predict`` of the
whole model atol 2e-5, the reference's own decode tolerance. Search
metadata, serialized graphs and parameter counts: exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu.ffconst as jconst
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.models.llama import (
    LlamaModelConfig as JLlamaModelConfig, create_llama as j_create_llama,
    import_hf_weights as j_import_hf_weights)
from flexflow_tpu.ops import OpRegistry as JRegistry
from flexflow_tpu.ops.attention import rotary_embedding as j_rope
from flexflow_tpu.ops.base import OpContext as JContext
from flexflow_tpu.search import unity as junity
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
import flexflow_tpu_torch.ffconst as pconst
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.models import (LlamaModelConfig, create_llama,
                                       import_hf_weights)
from flexflow_tpu_torch.ops import OpRegistry as PRegistry
from flexflow_tpu_torch.ops.attention import rotary_embedding
from flexflow_tpu_torch.ops.base import OpContext as PContext
from flexflow_tpu_torch.search import unity
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.weights import from_jax_params

OP_TOL = 1e-6
DECODE_TOL = 1e-5
MODEL_ATOL = 2e-5
# the reference's test configuration, and the grouped-query ratios 1 and 4
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, batch_size=2, seq_length=16)
GQA = {"rep2": 2, "rep1": 4, "rep4": 1}
# Mistral-7B-v0.3's config.json
MISTRAL = dict(vocab_size=32768, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=32, num_attention_heads=32,
               num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=1e6,
               batch_size=4, seq_length=1024)


def _layers(op_type, props):
    jl = JLayer(getattr(jconst.OperatorType, op_type), f"op_{op_type}", [])
    pl = PLayer(getattr(pconst.OperatorType, op_type), f"op_{op_type}", [])
    jl.properties.update({k: (getattr(jconst.AggrMode, v.name)
                              if isinstance(v, pconst.AggrMode) else v)
                          for k, v in props.items()})
    pl.properties.update(props)
    return jl, pl


def _pair(op_type, input_shapes, props, seed=0):
    """(JAX op, port op, params, inputs): the params random from a seed."""
    jl, pl = _layers(op_type, props)
    jop = JRegistry.create(jl, input_shapes)
    pop = PRegistry.create(pl, input_shapes)
    rs = np.random.RandomState(seed)
    shapes = {k: np.shape(v)
              for k, v in jop.init_params(jax.random.PRNGKey(0)).items()}
    params = {k: (rs.randn(*s) * 0.3 + (1.0 if k == "scale" else 0.0)
                  ).astype(np.float32) for k, s in shapes.items()}
    inputs = [rs.randn(*s).astype(np.float32) for s in input_shapes]
    return jop, pop, params, inputs


def _forward_both(jop, pop, params, inputs):
    (want,) = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                          [jnp.asarray(x) for x in inputs],
                          JContext(training=False, compute_dtype=jnp.float32))
    (got,) = pop.forward({k: torch.from_numpy(v) for k, v in params.items()},
                         [torch.from_numpy(x) for x in inputs],
                         PContext(training=False, compute_dtype=torch.float32))
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OP_TOL,
                               rtol=OP_TOL)


def _metadata_equal(jop, pop):
    assert pop.output_shapes == jop.output_shapes
    assert pop.flops() == jop.flops()
    assert pop.params_elems() == jop.params_elems()
    assert [[r.value for r in rr] for rr in pop.output_dim_roles()] \
        == [[r.value for r in rr] for rr in jop.output_dim_roles()]
    want = {k: tuple(np.shape(v)) for k, v in
            jop.init_params(jax.random.PRNGKey(0)).items()}
    assert {k: tuple(v) for k, v in pop.param_shapes().items()} == want
    ours = pop.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in ours.items()} == want


def test_aggr_mode_matches_jax():
    assert [(m.name, m.value) for m in pconst.AggrMode] \
        == [(m.name, m.value) for m in jconst.AggrMode]


# ---- RMSNorm, elementwise kinds -----------------------------------------------

UNARY = ["EXP", "SIN", "COS", "RELU", "GELU", "SIGMOID", "TANH", "ELU",
         "RSQRT", "LOG", "IDENTITY"]
SCALAR = {"SCALAR_MULTIPLY": 1.7, "SCALAR_ADD": -0.4, "SCALAR_SUB": 2.5,
          "SCALAR_TRUE_DIV": 3.0, "POW": 3}
BINARY = {"EW_ADD": [(2, 8, 32), (2, 8, 32)],
          "EW_SUB": [(2, 8, 32), (1, 8, 32)],
          "EW_MUL": [(2, 8, 32), (32,)],
          "EW_DIV": [(2, 8, 32), (2, 1, 32)],
          "EW_MAX": [(2, 8, 32), (2, 8, 32)],
          "EW_MIN": [(4, 16), (4, 16)]}
POSITIVE = {"RSQRT", "LOG", "EW_DIV"}  # inputs kept away from 0 and below


def _elementwise_case(name):
    if name in BINARY:
        return name, BINARY[name], {}
    return name, [(2, 8, 32)], dict(scalar=SCALAR.get(name), inplace=False)


ELEMENTWISE = UNARY + sorted(SCALAR) + sorted(BINARY)


@pytest.mark.parametrize("name", ELEMENTWISE)
def test_elementwise_forward_and_metadata_match_jax(name):
    jop, pop, params, inputs = _pair(*_elementwise_case(name))
    if name in POSITIVE:
        inputs = [np.abs(x) + 0.5 for x in inputs]
    _forward_both(jop, pop, params, inputs)
    _metadata_equal(jop, pop)


@pytest.mark.parametrize("shape", [(2, 8, 32), (4, 32)])
def test_rmsnorm_forward_and_metadata_match_jax(shape):
    jop, pop, params, inputs = _pair("RMSNORM", [shape], dict(eps=1e-5))
    _forward_both(jop, pop, params, inputs)
    _metadata_equal(jop, pop)


@pytest.mark.parametrize("aggr", list(pconst.AggrMode))
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_embedding_forward_and_metadata_match_jax(aggr, id_dtype):
    jop, pop, params, _ = _pair("EMBEDDING", [(3, 7)],
                                dict(num_entries=50, out_dim=16, aggr=aggr))
    ids = np.random.RandomState(1).randint(0, 50, (3, 7)).astype(id_dtype)
    _forward_both(jop, pop, params, [ids])
    _metadata_equal(jop, pop)


# ---- RoPE and the KV-cache decode_forward ---------------------------------------

@pytest.mark.parametrize("offset", [0, 5, "tensor"])
@pytest.mark.parametrize("theta,d", [(1e4, 16), (1e6, 128)])
def test_rotary_embedding_matches_jax(offset, theta, d):
    x = np.random.RandomState(2).randn(2, 3, 6, d).astype(np.float32)
    pos = 9 if offset == "tensor" else offset
    want = np.asarray(j_rope(jnp.asarray(x), theta=theta,
                             position_offset=(jnp.int32(pos)
                                              if offset == "tensor" else pos)))
    got = rotary_embedding(torch.from_numpy(x), theta=theta,
                           position_offset=(torch.tensor(pos,
                                                         dtype=torch.int32)
                                            if offset == "tensor" else pos))
    np.testing.assert_allclose(got.numpy(), want, atol=OP_TOL, rtol=OP_TOL)


@pytest.mark.parametrize("kv", sorted(GQA))
@pytest.mark.parametrize("pos,t", [(0, 5), (5, 1), (7, 3)])
def test_decode_forward_matches_jax(kv, pos, t):
    """``y`` and both caches after one block of ``t`` rows at ``pos``,
    over caches random everywhere (the mask must hide the rows beyond
    ``pos + t``, and the write must land at ``pos``); the port's position
    as a Python int and as an int32 tensor."""
    hk = GQA[kv]
    props = dict(embed_dim=64, num_heads=4, num_kv_heads=hk, bias=False,
                 causal=True, rope=True, rope_theta=1e4)
    jop, pop, params, _ = _pair("MULTIHEAD_ATTENTION", [(2, t, 64)] * 3,
                                props, seed=pos + t)
    rs = np.random.RandomState(3)
    x = rs.randn(2, t, 64).astype(np.float32)
    kc, vc = (rs.randn(2, hk, 12, 16).astype(np.float32) for _ in range(2))
    jy, jk, jv = jop.decode_forward(
        {k: jnp.asarray(v) for k, v in params.items()}, [jnp.asarray(x)],
        JContext(training=False, compute_dtype=jnp.float32),
        jnp.asarray(kc), jnp.asarray(vc), jnp.int32(pos))
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        y, k2, v2 = pop.decode_forward(
            {k: torch.from_numpy(v) for k, v in params.items()},
            [torch.from_numpy(x)],
            PContext(training=False, compute_dtype=torch.float32), pk, pv, p)
        assert k2 is pk and v2 is pv  # written in place
        for got, want in ((y, jy), (pk, jk), (pv, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=DECODE_TOL, rtol=DECODE_TOL)


def test_decode_forward_refuses_non_causal_like_jax():
    props = dict(embed_dim=32, num_heads=2, causal=False)
    jop, pop, params, _ = _pair("MULTIHEAD_ATTENTION", [(2, 1, 32)] * 3,
                                props)
    cache = torch.zeros(2, 2, 8, 16)
    x = torch.zeros(2, 1, 32)
    with pytest.raises(NotImplementedError) as got:
        pop.decode_forward({k: torch.from_numpy(v) for k, v in params.items()},
                           [x], PContext(), cache, cache.clone(), 0)
    with pytest.raises(NotImplementedError) as want:
        jop.decode_forward({k: jnp.asarray(v) for k, v in params.items()},
                           [jnp.zeros((2, 1, 32))], JContext(),
                           jnp.zeros((2, 2, 8, 16)), jnp.zeros((2, 2, 8, 16)),
                           0)
    assert str(got.value) == str(want.value)


# ---- the model ------------------------------------------------------------------

def _aligned():
    """Start both packages' layer and tensor counters at one value."""
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start


def _models(kv_heads=2, **extra):
    """(JAX model, port model, config), both compiled for INFERENCE, the
    port carrying the JAX model's parameters."""
    kw = dict(SMALL, num_key_value_heads=kv_heads, **extra)
    _aligned()
    jff = j_create_llama(JLlamaModelConfig(**kw),
                         J.FFConfig(batch_size=kw["batch_size"],
                                    workers_per_node=1))
    pff = create_llama(LlamaModelConfig(**kw),
                       P.FFConfig(batch_size=kw["batch_size"]), device="cpu")
    for ff, c in ((jff, J), (pff, P)):
        ff.compile(None, c.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [],
                   comp_mode=c.CompMode.INFERENCE)
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    return jff, pff, LlamaModelConfig(**kw)


def _ids(cfg, seed=0, dtype=np.int32):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (cfg.batch_size, cfg.seq_length)).astype(dtype)


@pytest.mark.parametrize("kv", sorted(GQA))
def test_predict_matches_jax(kv):
    jff, pff, cfg = _models(GQA[kv])
    ids = _ids(cfg)
    want = np.asarray(jff.predict(ids))
    got = pff.predict(ids)
    assert got.shape == want.shape == (2, 16, 256)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL)
    # int64 ids take the input's declared int32 dtype: one forward graph
    np.testing.assert_array_equal(pff.predict(ids.astype(np.int64)), got)
    assert pff.executor.step_graphs["forward"].captures == 1


def test_parameter_tree_matches_jax():
    jff, pff, _ = _models()
    assert {l: {n: tuple(t.shape) for n, t in sub.items()}
            for l, sub in pff.params.items()} == \
        {l: {n: tuple(np.shape(a)) for n, a in sub.items()}
         for l, sub in jff.params.items()}
    assert pff._declared_seq() == jff._declared_seq() == 16


def test_serialize_graph_matches_jax():
    _aligned()
    jff = j_create_llama(JLlamaModelConfig(**SMALL),
                         J.FFConfig(batch_size=2))
    pff = create_llama(LlamaModelConfig(**SMALL), P.FFConfig(batch_size=2),
                       device="cpu")
    got, want = [], []
    for ff, mod, out in ((jff, junity, want), (pff, unity, got)):
        nodes, _, ref = ff._materialize_nodes()
        final = ff._select_final_ref(nodes, ref)
        out.append(json.dumps(mod.serialize_graph(nodes,
                                                  final_guid=final[0]),
                              sort_keys=True))
    assert got == want


def test_mistral_widths_count_7_25_billion_parameters():
    """The graph at Mistral-7B-v0.3's widths, materialized without a
    parameter (nothing is allocated): 7,248,023,552 parameters, its
    attention on the flash core on the card and kv heads 8 of 32."""
    ff = create_llama(LlamaModelConfig(**MISTRAL), device="cpu")
    nodes, _, _ = ff._materialize_nodes()
    assert sum(n.op.params_elems() for n in nodes) == 7_248_023_552
    attn = [n.op for n in nodes
            if n.op.op_type == P.OperatorType.MULTIHEAD_ATTENTION]
    assert len(attn) == 32
    assert {(op.head_dim, op.num_kv_heads, op.causal) for op in attn} \
        == {(128, 8, True)}
    assert {op.selected_impl("cuda") for op in attn} == {"flash"}
    assert {op.selected_impl("cpu") for op in attn} == {"einsum"}


def test_served_rows_equal_predict():
    _, pff, cfg = _models()
    ids = _ids(cfg, seed=4)
    want = pff.predict(ids)
    engine = pff.serve(batch_buckets=(1, 2))
    reqs = [engine.submit([ids[i].astype(np.int64)]) for i in range(2)]
    reqs.append(engine.submit([ids[0]]))
    engine.pump()
    got = [r.wait(10) for r in reqs]
    np.testing.assert_allclose(np.stack(got[:2]), want, atol=1e-6)
    np.testing.assert_allclose(got[2], want[0], atol=1e-6)
    assert {b: be.executor.step_graphs["forward"].captures
            for b, be in engine.buckets.items()} == {1: 1, 2: 1}


def test_serve_workload_llama_builds_on_cpu():
    from flexflow_tpu_torch.serve.loadgen import build_serve_model

    ff, make, cfg = build_serve_model("llama", on_cpu=True, device="cpu")
    assert cfg["num_hidden_layers"] == 2 and cfg["batch_size"] == 8
    out = ff.predict(np.stack([make(i)[0] for i in range(8)]))
    assert out.shape == (8, 32, 256) and np.isfinite(out).all()


# ---- import_hf_weights ----------------------------------------------------------

class _HF:
    """A HuggingFace ``LlamaForCausalLM``-layout model: ``state_dict()``
    and ``config``, made with numpy from a seed."""

    def __init__(self, tied, seed=0):
        c = SMALL
        self.config = type("Config", (), dict(
            num_attention_heads=c["num_attention_heads"],
            num_key_value_heads=c["num_key_value_heads"],
            hidden_size=c["hidden_size"],
            num_hidden_layers=c["num_hidden_layers"]))()
        rs = np.random.RandomState(seed)
        e, f, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
        d = e // c["num_attention_heads"]
        hk = c["num_key_value_heads"] * d
        w = lambda *s: (rs.randn(*s) * 0.1).astype(np.float32)
        sd = {"model.embed_tokens.weight": w(v, e),
              "model.norm.weight": 1 + w(e)}
        for i in range(c["num_hidden_layers"]):
            p = f"model.layers.{i}."
            sd.update({p + "input_layernorm.weight": 1 + w(e),
                       p + "post_attention_layernorm.weight": 1 + w(e),
                       p + "self_attn.q_proj.weight": w(e, e),
                       p + "self_attn.k_proj.weight": w(hk, e),
                       p + "self_attn.v_proj.weight": w(hk, e),
                       p + "self_attn.o_proj.weight": w(e, e),
                       p + "mlp.gate_proj.weight": w(f, e),
                       p + "mlp.up_proj.weight": w(f, e),
                       p + "mlp.down_proj.weight": w(e, f)})
        if not tied:
            sd["lm_head.weight"] = w(v, e)
        self._sd = {k: torch.from_numpy(a) for k, a in sd.items()}

    def state_dict(self):
        return dict(self._sd)


@pytest.mark.parametrize("tied", [False, True])
def test_import_hf_weights_matches_jax(tied):
    jff, pff, cfg = _models()
    hf = _HF(tied)
    assert import_hf_weights(pff, hf) == j_import_hf_weights(jff, hf) \
        == 3 + 9 * 2
    ids = _ids(cfg, seed=5)
    np.testing.assert_allclose(pff.predict(ids), np.asarray(jff.predict(ids)),
                               atol=MODEL_ATOL)
    if tied:
        np.testing.assert_array_equal(
            pff.get_parameter("lm_head"),
            pff.get_parameter("embed_tokens").T)
