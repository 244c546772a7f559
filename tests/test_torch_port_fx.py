"""PyTorch port, the torch.fx frontend against the JAX package's.

Every model of ``tests/test_torch_frontend.py`` is traced and imported
through both packages' ``PyTorchModel.torch_to_ff`` (the port on the
CPU), both get the module's own weights (``copy_weights_to``), and then:
- ``predict`` of the two packages agree, and each agrees with the
  module's own forward, at the reference test's tolerance for that model
  (rtol 2e-3 / atol 2e-4 for the attention models, 1e-3 / 1e-4 for the
  convs, 1e-4 / 1e-5 elsewhere; the imported GELU is the tanh form in
  both packages, torch's ``F.gelu`` the erf form);
- after one SGD step (lr 0.01, MSE) in each package, the losses on the
  batch agree at rtol 1e-4 (f32 on both sides, sums in other orders).

Also: the ``.ff`` file written by the port and read by both packages;
the bare-parameter leaf that trains; the one-step loss against torch
autograd's (rtol 5e-2, as the reference test holds it); the search
request and strategy JSON of an imported graph that uses the new ops, at
1 and 4 devices (the JAX package's ``cpu-sim`` machine, guids aligned);
the HuggingFace Llama path where ``transformers`` is installed.
"""

import copy
import json

import numpy as np
import pytest
import torch
import torch.nn as nn

import flexflow_tpu as J
import flexflow_tpu.ffconst as jconst
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.machine import MachineSpec as JMachineSpec
from flexflow_tpu.optimizers import SGDOptimizer as JSGD
from flexflow_tpu.search import unity as junity
from flexflow_tpu.tensor import Tensor as JTensor
from flexflow_tpu.torch import PyTorchModel as JPyTorchModel
import flexflow_tpu_torch as P
import flexflow_tpu_torch.ffconst as pconst
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.machine import MachineSpec
from flexflow_tpu_torch.optimizers import SGDOptimizer as PSGD
from flexflow_tpu_torch.search import unity
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.torch import PyTorchModel, torch_to_ff_file

LOSS_RTOL = 1e-4


class SmallMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 32)
        self.act = nn.ReLU()
        self.fc2 = nn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class BranchyNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Linear(16, 32)
        self.b = nn.Linear(16, 32)
        self.out = nn.Linear(32, 4)

    def forward(self, x):
        return self.out(torch.relu(self.a(x)) + torch.tanh(self.b(x)))


class ScalarLeftNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(16, 4)

    def forward(self, x):
        return 1.0 - self.fc(x) * 0.5


class AttnNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(32, 4, batch_first=True)
        self.fc = nn.Linear(32, 4)

    def forward(self, x):
        out, _ = self.attn(x, x, x)
        return self.fc(out)


class SmallCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(1, 4, 3)
        self.pool = nn.MaxPool2d(2)
        self.flat = nn.Flatten()
        self.fc = nn.Linear(4 * 5 * 5, 3)

    def forward(self, x):
        return self.fc(self.flat(self.pool(torch.relu(self.conv(x)))))


class PosMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.pos = nn.Parameter(torch.randn(16) * 0.1)
        self.fc = nn.Linear(16, 4)

    def forward(self, x):
        return self.fc(x + self.pos)


class TransformerBlockNet(nn.Module):
    def __init__(self, e=32, h=4, f=64):
        super().__init__()
        self.ln1 = nn.LayerNorm(e)
        self.attn = nn.MultiheadAttention(e, h, batch_first=True)
        self.ln2 = nn.LayerNorm(e)
        self.ff1 = nn.Linear(e, f)
        self.ff2 = nn.Linear(f, e)
        self.head = nn.Linear(e, 4)

    def forward(self, x):
        a, _ = self.attn(self.ln1(x), self.ln1(x), self.ln1(x),
                         need_weights=False)
        x = x + a
        x = x + self.ff2(torch.relu(self.ff1(self.ln2(x))))
        return self.head(x)


class EncNet(nn.Module):
    def __init__(self, norm_first):
        super().__init__()
        self.enc = nn.TransformerEncoder(
            nn.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                       batch_first=True,
                                       norm_first=norm_first),
            num_layers=2, enable_nested_tensor=False)
        self.head = nn.Linear(32, 4)

    def forward(self, x):
        return self.head(self.enc(x))


class FnNet(nn.Module):
    def forward(self, x):
        a = torch.exp(x).rsqrt()
        b = torch.sqrt(torch.relu(x) + 1.0)
        c, d = torch.chunk(a * b, 2, dim=1)
        e = torch.stack([c, d], dim=1)
        f = e.reshape(e.shape[0], -1)
        return nn.functional.silu(f).unsqueeze(1).squeeze(1)


class PoolNet(nn.Module):
    def forward(self, x):
        a = nn.functional.max_pool2d(torch.relu(x), 2, 2)
        b = nn.functional.avg_pool2d(a, kernel_size=2)
        return nn.functional.adaptive_avg_pool2d(b, 1).flatten(1)


class MiniGPT2(nn.Module):
    """The reference test's GPT-2-style causal block: packed qkv, chunk,
    view/transpose, matmul, an additive causal-mask buffer, softmax and
    a GELU MLP."""

    def __init__(self, e=32, h=4, s=8):
        super().__init__()
        self.e, self.h, self.s = e, h, s
        self.ln_1 = nn.LayerNorm(e)
        self.c_attn = nn.Linear(e, 3 * e)
        self.c_proj = nn.Linear(e, e)
        self.ln_2 = nn.LayerNorm(e)
        self.mlp_fc = nn.Linear(e, 4 * e)
        self.mlp_proj = nn.Linear(4 * e, e)
        bias = (1.0 - torch.tril(torch.ones(s, s))) * -1e9
        self.register_buffer("attn_bias", bias.view(1, 1, s, s))

    def forward(self, x):
        b = x.shape[0]
        e, h, s = self.e, self.h, self.s
        d = e // h
        a = self.ln_1(x)
        qkv = self.c_attn(a)
        q, k, v = qkv.chunk(3, dim=2)
        q = q.view(b, s, h, d).transpose(1, 2)
        k = k.view(b, s, h, d).transpose(1, 2)
        v = v.view(b, s, h, d).transpose(1, 2)
        att = torch.matmul(q, k.transpose(2, 3)) * (1.0 / d ** 0.5)
        att = att + self.attn_bias
        att = torch.softmax(att, dim=-1)
        y = torch.matmul(att, v)
        y = y.transpose(1, 2).reshape(b, s, e)
        x = x + self.c_proj(y)
        m = self.mlp_proj(torch.nn.functional.gelu(self.mlp_fc(self.ln_2(x))))
        return x + m


class NewKindsNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(16, 16)
        self.register_buffer("mask", (torch.arange(16) % 2 == 0).float())

    def forward(self, x):
        h = self.fc(x)
        h = h.masked_fill(self.mask > 0.5, 0.25)
        h = torch.clamp(h, min=-2.0, max=2.0)
        g = torch.einsum("bi,bj->bij", h, h)
        g = g.amax(dim=2)
        g = torch.abs(g)
        z = torch.where(self.mask > 0.5, g, h)
        return torch.log_softmax(z, dim=-1)


class GroupNormNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(8, 8, 3, padding=1)
        self.gn = nn.GroupNorm(4, 8)
        self.act = nn.SiLU()

    def forward(self, x):
        return self.act(self.gn(self.conv(x)))


class SDPANet(nn.Module):
    def __init__(self):
        super().__init__()
        self.qkv = nn.Linear(32, 96)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)


# name -> (module factory, input shape, batch, (rtol, atol) against torch)
ATTN_TOL = (2e-3, 2e-4)
CONV_TOL = (1e-3, 1e-4)
FN_TOL = (1e-4, 1e-5)
MODELS = {
    "mlp": (SmallMLP, (16,), 8, FN_TOL),
    "branchy": (BranchyNet, (16,), 8, FN_TOL),
    "cnn": (SmallCNN, (1, 12, 12), 8, CONV_TOL),
    "scalar_left": (ScalarLeftNet, (16,), 8, FN_TOL),
    "mha_getitem": (AttnNet, (6, 32), 8, ATTN_TOL),
    "bare_parameter": (PosMLP, (16,), 8, FN_TOL),
    "mha_block": (TransformerBlockNet, (8, 32), 4, ATTN_TOL),
    "encoder_post_norm": (lambda: EncNet(False), (8, 32), 4, ATTN_TOL),
    "encoder_pre_norm": (lambda: EncNet(True), (8, 32), 4, ATTN_TOL),
    "functions": (FnNet, (16,), 4, FN_TOL),
    "functional_pools": (PoolNet, (3, 16, 16), 2, (1e-5, 1e-6)),
    "gpt2_block": (MiniGPT2, (8, 32), 4, ATTN_TOL),
    "new_kinds": (NewKindsNet, (16,), 8, FN_TOL),
    "group_norm_silu": (GroupNormNet, (8, 8, 8), 4, CONV_TOL),
    "sdpa": (SDPANet, (4, 8, 32), 2, ATTN_TOL),
}


def _aligned():
    """Start both packages' layer and tensor counters at one value."""
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start


def _build(pkg, importer, module, in_shape, batch, compile=True, **kw):
    cfg = pkg.FFConfig(batch_size=batch, only_data_parallel=True,
                       workers_per_node=1)
    ff = pkg.FFModel(cfg, **kw)
    t = ff.create_tensor((batch,) + in_shape)
    importer(module).torch_to_ff(ff, [t])
    if compile:
        sgd = PSGD if pkg is P else JSGD
        ff.compile(sgd(lr=0.01), pkg.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [])
    return ff


def _pair(name):
    """(module, JAX model, port model, x): both compiled from one trace,
    both holding the module's own weights."""
    factory, in_shape, batch, _ = MODELS[name]
    torch.manual_seed(len(name))
    module = factory().eval()
    # each package traces its own copy: fx names a tensor constant after
    # the attributes the module already holds, and tracing sets them
    twin = copy.deepcopy(module)
    _aligned()
    jff = _build(J, JPyTorchModel, twin, in_shape, batch)
    pff = _build(P, PyTorchModel, module, in_shape, batch, device="cpu")
    nj = JPyTorchModel(twin).copy_weights_to(jff)
    np_ = PyTorchModel(module).copy_weights_to(pff)
    assert np_ == nj
    rs = np.random.RandomState(len(name))
    x = rs.randn(batch, *in_shape).astype(np.float32)
    if name == "functions":
        x = rs.rand(batch, *in_shape).astype(np.float32) + 0.5
    return module, jff, pff, x


@pytest.mark.parametrize("name", sorted(MODELS))
def test_imported_model_matches_jax_and_torch(name):
    module, jff, pff, x = _pair(name)
    rtol, atol = MODELS[name][3]
    assert [l.name for l in pff.layers] == [l.name for l in jff.layers]
    want_torch = module(torch.from_numpy(x)).detach().numpy()
    got, want = pff.predict(x), np.asarray(jff.predict(x))
    assert got.shape == want.shape == want_torch.shape
    np.testing.assert_allclose(got, want_torch, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # one SGD step each: the losses on the batch after it agree
    y = np.random.RandomState(7).randn(*got.shape).astype(np.float32)
    jff.fit(x, y, epochs=1, verbose=False)
    pff.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_allclose(pff._last_loss, float(jff._last_loss),
                               rtol=LOSS_RTOL)
    after_p = float(((pff.predict(x) - y) ** 2).mean())
    after_j = float(((np.asarray(jff.predict(x)) - y) ** 2).mean())
    np.testing.assert_allclose(after_p, after_j, rtol=LOSS_RTOL)


def test_bare_parameter_is_a_trainable_leaf():
    _, jff, pff, x = _pair("bare_parameter")
    leaves = [l.name for l in pff.layers if l.properties.get("trainable")]
    assert leaves == ["pos"]
    before = pff.get_parameter("pos", "weight").copy()
    y = np.random.RandomState(0).randn(8, 4).astype(np.float32)
    pff.fit(x, y, epochs=2, verbose=False)
    assert not np.allclose(before, pff.get_parameter("pos", "weight"))


def test_one_sgd_step_matches_torch_autograd():
    """The reference test's bar: the imported block and the module take one
    SGD step each (lr 0.01, MSE); the losses agree before (rtol 1e-3) and
    after it (rtol 5e-2)."""
    torch.manual_seed(2)
    m = TransformerBlockNet()
    pff = _build(P, PyTorchModel, m, (8, 32), 4, device="cpu")
    PyTorchModel(m).copy_weights_to(pff)
    rs = np.random.RandomState(2)
    x = rs.randn(4, 8, 32).astype(np.float32)
    y = rs.randn(4, 8, 4).astype(np.float32)
    crit = nn.MSELoss()
    with torch.no_grad():
        loss_t0 = float(crit(m(torch.from_numpy(x)), torch.from_numpy(y)))
    np.testing.assert_allclose(float(((pff.predict(x) - y) ** 2).mean()),
                               loss_t0, rtol=1e-3)
    opt = torch.optim.SGD(m.parameters(), lr=0.01)
    crit(m(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    opt.step()
    with torch.no_grad():
        loss_t1 = float(crit(m(torch.from_numpy(x)), torch.from_numpy(y)))
    pff.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_allclose(float(((pff.predict(x) - y) ** 2).mean()),
                               loss_t1, rtol=5e-2)


def test_ff_file_round_trip_through_both_packages(tmp_path):
    """The port writes the ``.ff`` file; both packages replay it with no
    module at hand and build the same layers."""
    path = str(tmp_path / "model.ff")
    torch_to_ff_file(MiniGPT2(), path, {"x": (8, 32)})
    with open(path) as f:
        assert json.load(f)["version"] == 1
    _aligned()
    jff = _build(J, lambda _: JPyTorchModel.from_file(path), None, (8, 32), 4,
                 compile=False)
    pff = _build(P, lambda _: PyTorchModel.from_file(path), None, (8, 32), 4,
                 compile=False, device="cpu")
    assert [(l.name, l.op_type.name) for l in pff.layers] \
        == [(l.name, l.op_type.name) for l in jff.layers]
    pff.compile(PSGD(lr=0.01), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    x = np.random.RandomState(3).randn(4, 8, 32).astype(np.float32)
    assert pff.predict(x).shape == (4, 8, 32)


def _search_pair(name):
    factory, in_shape, batch, _ = MODELS[name]
    torch.manual_seed(0)
    module = factory().eval()
    _aligned()
    jff = _build(J, JPyTorchModel, copy.deepcopy(module), in_shape, batch,
                 compile=False)
    pff = _build(P, PyTorchModel, module, in_shape, batch, compile=False,
                 device="cpu")
    return jff, pff


def _graph(ff):
    nodes, _, tensor_ref = ff._materialize_nodes()
    return nodes, ff._select_final_ref(nodes, tensor_ref)


def _dumps(x):
    return json.dumps(x, sort_keys=True)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("name", ["gpt2_block", "new_kinds"])
def test_imported_graph_search_matches_jax(name, n):
    """The serialized graph and the searched strategy JSON of an imported
    graph (reshape, transpose, batch_matmul, constant, einsum, where,
    reduce_max, ...) are the JAX package's, byte for byte."""
    jff, pff = _search_pair(name)
    (jn, jf), (pn, pf) = _graph(jff), _graph(pff)
    assert _dumps(unity.serialize_graph(pn, final_guid=pf[0])) \
        == _dumps(junity.serialize_graph(jn, final_guid=jf[0]))
    out = []
    for ff, mod, spec, mode in ((jff, junity, JMachineSpec, jconst),
                                (pff, unity, MachineSpec, pconst)):
        cfg = ff.config
        cfg.search_budget = 2
        cfg.computation_mode = mode.CompMode.TRAINING
        cfg.opt_state_factor = 0.0
        nodes, final = _graph(ff)
        mesh, st, info = mod.graph_optimize(
            nodes, spec(chip="cpu-sim", chips_per_slice=n), cfg, n,
            batch=ff.input_tensors[0].shape[0], final_ref=final)
        out.append((mod.strategy_json(mesh, st,
                                      info.get("rewritten_nodes", nodes),
                                      objective=info["objective"]),
                    info["predicted_time"]))
    (want, want_t), (got, got_t) = out
    assert _dumps(got) == _dumps(want)
    assert got_t == want_t


def test_from_hf_causal_lm_matches_hf_and_jax():
    """The HuggingFace Llama path (needs ``transformers``): the port's
    ``create_llama`` with the HF state dict, on the CPU, against HF's
    logits (rtol/atol 2e-3, the reference test's) and the JAX package's."""
    transformers = pytest.importorskip("transformers")
    from flexflow_tpu.torch.model import from_hf_causal_lm as j_from_hf
    from flexflow_tpu_torch.torch import from_hf_causal_lm

    hf_cfg = transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=32, rms_norm_eps=1e-6, rope_theta=10000.0,
        attention_bias=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    _aligned()
    jff, jload = j_from_hf(hf, batch_size=2, seq_length=8,
                           ff_config=J.FFConfig(batch_size=2,
                                                workers_per_node=1))
    pff, pload = from_hf_causal_lm(hf, batch_size=2, seq_length=8,
                                   device="cpu")
    for ff, sgd, pkg in ((jff, JSGD, J), (pff, PSGD, P)):
        ff.compile(sgd(lr=0.01), pkg.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                   [])
    assert pload() == jload() == 3 + 9 * 2
    ids = np.random.RandomState(0).randint(0, 64, (2, 8)).astype(np.int32)
    want = hf(torch.from_numpy(ids.astype(np.int64))).logits.detach().numpy()
    got = pff.predict(ids)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, np.asarray(jff.predict(ids)), rtol=2e-3,
                               atol=2e-3)


def test_module_on_another_device_copies_through_the_host():
    """``copy_weights_to`` reads parameters through the host, so a module
    in bf16 (or on the card) imports as its f32 values."""
    torch.manual_seed(0)
    m = SmallMLP().to(torch.bfloat16)
    pff = _build(P, PyTorchModel, m, (16,), 8, device="cpu")
    assert PyTorchModel(m).copy_weights_to(pff) == 2
    np.testing.assert_array_equal(pff.get_parameter("fc1", "kernel"),
                                  m.fc1.weight.detach().float().numpy().T)
