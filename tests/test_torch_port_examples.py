"""PyTorch port, the example scripts (``examples_torch/``) against the JAX
package's (``examples/``).

- Build: each of the eleven scripts, run with ``-b 8`` up to its
  ``train_synthetic`` call (replaced here by a stop), builds its model at
  its own (the reference's) config; the two packages' models, built from
  one layer counter, have the same op list, shapes and search metadata
  (``search.unity.serialize_graph``: the native core's request, byte for
  byte), and the same synthetic input specs, labels, loss and metrics.
  No compile runs: the full configs (ResNet-50 at 224 px, XDL's 4 x 10^6
  embedding rows) are layers only.
- Run: each port script's ``main()`` on the CPU (``--device cpu -b 8
  --iterations 1``) at a small size set here by replacing its config (or
  builder) name with a smaller one: the ``mesh:`` line, the
  ``ELAPSED TIME = .. THROUGHPUT = .. samples/s`` line, a finite loss.
- Losses: ``mlp.py`` and ``transformer.py`` at the small size in
  both packages (the JAX side on conftest's 8 CPU devices), the port's
  parameters carried from the JAX model by ``weights.from_jax_params``;
  all five steps' losses (the first before any update, the next four
  after the example loop's SGD updates) within rtol 1e-4 (f32 on both
  sides; only the order of the sums differs).
"""

import functools
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu.models as JM
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.search import unity as junity
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
import flexflow_tpu_torch.models as PM
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.search import unity as punity
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["alexnet", "candle_uno", "dlrm", "inception", "llama_lm", "mlp",
            "moe", "resnet", "resnext", "transformer", "xdl"]
LOSS_RTOL = 1e-4


def _load(folder, name):
    """``folder/name.py`` as a module, with its sibling ``common.py``
    bound as the ``common`` it imports (both packages' scripts say
    ``from common import ...``)."""
    saved = sys.modules.pop("common", None)
    try:
        spec = importlib.util.spec_from_file_location(
            "common", os.path.join(REPO, folder, "common.py"))
        common = importlib.util.module_from_spec(spec)
        sys.modules["common"] = common
        spec.loader.exec_module(common)
        spec = importlib.util.spec_from_file_location(
            f"_example_{folder}_{name}", os.path.join(REPO, folder,
                                                      f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop("common", None)
        if saved is not None:
            sys.modules["common"] = saved
    return mod


class _Built(Exception):
    def __init__(self, ff, args, kwargs):
        super().__init__("built")
        self.ff, self.args, self.kwargs = ff, args, kwargs


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


def _run(mod, argv, monkeypatch, jax_side):
    """``mod.main()`` with ``argv``: the JAX scripts read ``sys.argv``,
    the port's take ``argv``."""
    if jax_side:
        monkeypatch.setattr(sys, "argv", [mod.__name__] + list(argv))
        return mod.main()
    return mod.main(list(argv))


def _built(mod, argv, monkeypatch, jax_side):
    def stop(ff, cfg, *args, **kwargs):
        raise _Built(ff, args, kwargs)
    monkeypatch.setattr(mod, "train_synthetic", stop)
    with pytest.raises(_Built) as e:
        _run(mod, argv, monkeypatch, jax_side)
    return e.value


def _request(ff, unity):
    nodes, _, tensor_ref = ff._materialize_nodes()
    final = ff._select_final_ref(nodes, tensor_ref)
    return json.dumps(unity.serialize_graph(nodes, final_guid=final[0]),
                      sort_keys=True)


def _names(kwargs):
    out = {}
    for k, v in kwargs.items():
        if k == "loss":
            v = v.name
        elif k == "metrics":
            v = [m.name for m in v]
        elif k == "optimizer":
            v = type(v).__name__
        out[k] = v
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_script_builds_the_references_model(name, monkeypatch):
    jmod, pmod = _load("examples", name), _load("examples_torch", name)
    starts = _starts()
    jb = _built(jmod, ["-b", "8"], monkeypatch, jax_side=True)
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    pb = _built(pmod, ["-b", "8", "--device", "cpu"], monkeypatch,
                jax_side=False)
    _settle()
    assert pb.ff.device.type == "cpu"
    assert [t.shape for t in pb.ff.input_tensors] \
        == [t.shape for t in jb.ff.input_tensors]
    assert [(l.op_type.name, l.name) for l in pb.ff.layers] \
        == [(l.op_type.name, l.name) for l in jb.ff.layers]
    assert _request(pb.ff, punity) == _request(jb.ff, junity)
    assert [tuple(map(str, s)) for s in pb.args[0]] \
        == [tuple(map(str, s)) for s in jb.args[0]]
    assert pb.args[1:] == jb.args[1:]
    assert _names(pb.kwargs) == _names(jb.kwargs)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the small CPU steps gain nothing from a wide thread pool, and under
    # a parallel pytest run its spinning threads lose to the other
    # workers' processes; the pool's width comes back after this file
    import torch
    width = torch.get_num_threads()
    torch.set_num_threads(min(width, 2))
    yield
    torch.set_num_threads(width)


# the small sizes the run tests set: a config (or builder) name of the
# script module -> its small stand-in
SMALL = {
    "alexnet": ("create_alexnet", lambda: functools.partial(
        PM.create_alexnet, image_size=64)),
    "candle_uno": ("CandleUnoConfig", lambda: functools.partial(
        PM.CandleUnoConfig, dense_layers=(32,) * 2,
        dense_feature_layers=(32,) * 2,
        input_features={"dose1": 1, "cell": 24, "drug_desc": 40})),
    "dlrm": ("DLRMConfig", lambda: functools.partial(
        PM.DLRMConfig, vocab_size=1000, num_sparse_features=4)),
    "inception": ("InceptionConfig", lambda: functools.partial(
        PM.InceptionConfig, image_size=75, num_classes=10, reduced=True)),
    "llama_lm": (None, None),  # its default config is already tiny
    "moe": (None, None),  # so is the MoE classifier's
    "mlp": ("create_mlp", lambda: (
        lambda bs, i, hidden, o, **kw: PM.create_mlp(bs, i, [64] * 4, o,
                                                     **kw))),
    "resnet": ("ResNetConfig", lambda: functools.partial(
        PM.ResNetConfig, image_size=32, stages=(1, 1, 1, 1))),
    "resnext": ("ResNeXtConfig", lambda: functools.partial(
        PM.ResNeXtConfig, image_size=32, stages=(1, 1, 1, 1),
        cardinality=8)),
    "transformer": ("TransformerConfig", lambda: functools.partial(
        PM.TransformerConfig, num_layers=2, hidden_size=64, num_heads=4,
        seq_length=32)),
    "xdl": ("XDLConfig", lambda: functools.partial(
        PM.XDLConfig, embedding_size=(1000, 1000))),
}


@pytest.mark.parametrize("name", EXAMPLES)
def test_script_runs_on_the_cpu(name, monkeypatch, capsys):
    mod = _load("examples_torch", name)
    attr, small = SMALL[name]
    if attr is not None:
        monkeypatch.setattr(mod, attr, small())
    seen = []
    real = mod.train_synthetic

    def record(ff, *args, **kwargs):
        seen.append(ff)
        return real(ff, *args, **kwargs)

    monkeypatch.setattr(mod, "train_synthetic", record)
    mod.main(["-b", "8", "--iterations", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mesh: {'data': 1}" in out
    line = [s for s in out.splitlines() if s.startswith("ELAPSED TIME = ")]
    assert len(line) == 1 and "THROUGHPUT = " in line[0] \
        and line[0].endswith(" samples/s")
    (ff,) = seen
    assert ff.input_tensors[0].shape[0] == 8
    assert math.isfinite(ff._last_loss)
    assert ff._iter == 5  # the warm-up step and max(iterations, 4)


FIRST_LOSS = {
    "mlp": ("create_mlp", lambda M: (
        lambda bs, i, hidden, o, **kw: M.create_mlp(bs, i, [64] * 4, o,
                                                    **kw))),
    "transformer": ("TransformerConfig", lambda M: functools.partial(
        M.TransformerConfig, num_layers=2, hidden_size=64, num_heads=4,
        seq_length=32)),
}


@pytest.mark.parametrize("name", sorted(FIRST_LOSS))
def test_first_loss_matches_the_reference(name, monkeypatch):
    import jax
    attr, small = FIRST_LOSS[name]
    jmod, pmod = _load("examples", name), _load("examples_torch", name)
    monkeypatch.setattr(jmod, attr, small(JM))
    monkeypatch.setattr(pmod, attr, small(PM))
    losses = {"jax": [], "port": []}
    carried = {}

    def wrap(cls, key):
        compile_, update = cls.compile, cls.update

        def compile_then(self, *a, **kw):
            compile_(self, *a, **kw)
            if key == "jax":
                carried["params"] = jax.tree.map(np.asarray, self.params)
            else:
                from_jax_params(carried["params"], self)

        def update_then(self):
            update(self)
            losses[key].append(float(self._last_loss))

        monkeypatch.setattr(cls, "compile", compile_then)
        monkeypatch.setattr(cls, "update", update_then)

    wrap(J.FFModel, "jax")
    wrap(P.FFModel, "port")
    starts = _starts()
    _run(jmod, ["-b", "8", "--iterations", "1"], monkeypatch, jax_side=True)
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    _run(pmod, ["-b", "8", "--iterations", "1", "--device", "cpu"],
         monkeypatch, jax_side=False)
    _settle()
    assert len(losses["port"]) == len(losses["jax"]) == 5
    assert all(math.isfinite(v) for v in losses["port"])
    # the first loss comes before any update; the next four hold the
    # port's set_batch/forward/zero_gradients/backward/update loop (its
    # SGD update included) to the JAX package's, step by step
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               rtol=LOSS_RTOL)
