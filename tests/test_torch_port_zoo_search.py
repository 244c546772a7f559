"""PyTorch port, the Unity search on the OSDI'22 protocol's other five
models against the JAX package: DLRM, XDL, CANDLE-Uno, ResNeXt-50 and
Inception-v3 at the small configurations of
``tests/test_torch_port_zoo.py``, the vision models at batch 4 (a batch
the search can split over 4 devices).

Both packages number layers with a process-wide counter; each pair is
built from the same counter value, so op guids and the names derived
from them agree and whole requests compare. The machine is the JAX
package's ``"cpu-sim"``.

Tolerances: the serialized graph, the request and the strategy JSON
exact (the same bytes through ``json.dumps``), the predicted times exact
(the same native core on the same request); the first loss of a searched
compile rtol 1e-4 (f32 on both sides, sums in different orders).
"""

import json

import jax
import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu.ffconst as jconst
import flexflow_tpu.search.native as jnative
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.machine import MachineSpec as JMachineSpec
from flexflow_tpu.optimizers import AdamOptimizer as JAdam
from flexflow_tpu.search import unity as junity
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
import flexflow_tpu_torch.ffconst as pconst
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.machine import MachineSpec
from flexflow_tpu_torch.models import (CandleUnoConfig, DLRMConfig,
                                       InceptionConfig, ResNeXtConfig,
                                       XDLConfig, create_candle_uno,
                                       create_dlrm, create_inception_v3,
                                       create_resnext50, create_xdl)
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.search import native, unity
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.weights import from_jax_params

DEVICES = (1, 4)
LOSS_RTOL = 1e-4
MSE, SCE = "MEAN_SQUARED_ERROR_AVG_REDUCE", "SPARSE_CATEGORICAL_CROSSENTROPY"
# name -> (port builder, config class, config fields, the JAX package's
# class names, loss, input shapes (int: ids below it), label shape and
# kind)
MODELS = {
    "dlrm": (create_dlrm, DLRMConfig,
             dict(batch_size=8, vocab_size=1000, num_sparse_features=4),
             ("create_dlrm", "DLRMConfig"), MSE,
             [((8, 1), 1000)] * 4 + [((8, 16), None)], ((8, 1), None)),
    "xdl": (create_xdl, XDLConfig,
            dict(batch_size=8, embedding_size=(1000, 1000)),
            ("create_xdl", "XDLConfig"), SCE, [((8, 1), 1000)] * 2,
            ((8, 1), 2)),
    "candle_uno": (create_candle_uno, CandleUnoConfig,
                   dict(batch_size=8, dense_layers=(32,) * 2,
                        dense_feature_layers=(32,) * 2,
                        input_features={"dose1": 1, "cell": 24,
                                        "drug_desc": 40}),
                   ("create_candle_uno", "CandleUnoConfig"), MSE,
                   [((8, 1), None), ((8, 24), None), ((8, 40), None)],
                   ((8, 1), None)),
    "resnext": (create_resnext50, ResNeXtConfig,
                dict(batch_size=4, image_size=32, stages=(1, 1, 1, 1),
                     cardinality=8),
                ("create_resnext50", "ResNeXtConfig"), SCE,
                [((4, 3, 32, 32), None)], ((4, 1), 1000)),
    "inception": (create_inception_v3, InceptionConfig,
                  dict(batch_size=4, image_size=75, num_classes=10,
                       reduced=True),
                  ("create_inception_v3", "InceptionConfig"), SCE,
                  [((4, 3, 75, 75), None)], ((4, 1), 10)),
}


def _aligned():
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start


def _pair(name, **cfg):
    """(JAX model, port model) of ``name``, uncompiled, guids aligned."""
    import flexflow_tpu.models as jmodels

    pb, pc, kw, (jb, jc), *_ = MODELS[name]
    _aligned()
    jff = getattr(jmodels, jb)(getattr(jmodels, jc)(**kw), J.FFConfig(
        batch_size=kw["batch_size"], workers_per_node=1, **cfg))
    pff = pb(pc(**kw), P.FFConfig(batch_size=kw["batch_size"], **cfg),
             device="cpu")
    return jff, pff


def _graph(ff):
    nodes, _, tensor_ref = ff._materialize_nodes()
    return nodes, ff._select_final_ref(nodes, tensor_ref)


def _search_config(ff, budget=2):
    cfg = ff.config
    cfg.search_budget = budget
    mode = jconst.CompMode if isinstance(ff, J.FFModel) else pconst.CompMode
    cfg.computation_mode = mode.TRAINING
    cfg.opt_state_factor = 2.0
    return cfg


def _dumps(x):
    return json.dumps(x, sort_keys=True)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_serialize_graph_matches(name):
    jff, pff = _pair(name)
    (jn, jf), (pn, pf) = _graph(jff), _graph(pff)
    assert _dumps(unity.serialize_graph(pn, final_guid=pf[0])) \
        == _dumps(junity.serialize_graph(jn, final_guid=jf[0]))


@pytest.mark.parametrize("n", DEVICES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_request_and_strategy_json_match(name, n, monkeypatch):
    """The request each package hands its native core, and the strategy
    the search returns (as the JSON a strategy file holds), at ``n``
    devices."""
    seen = {"jax": [], "port": []}
    for mod, key in ((jnative, "jax"), (native, "port")):
        real = mod.native_optimize

        def spy(req, real=real, key=key):
            seen[key].append(json.loads(json.dumps(req)))
            return real(req)

        monkeypatch.setattr(mod, "native_optimize", spy)
    jff, pff = _pair(name)
    out = []
    for ff, mod, spec in ((jff, junity, JMachineSpec),
                          (pff, unity, MachineSpec)):
        nodes, final = _graph(ff)
        mesh, st, info = mod.graph_optimize(
            nodes, spec(chip="cpu-sim", chips_per_slice=n),
            _search_config(ff), n, batch=MODELS[name][2]["batch_size"],
            final_ref=final)
        out.append((mod.strategy_json(mesh, st,
                                      info.get("rewritten_nodes", nodes),
                                      objective=info["objective"]),
                    info["predicted_time"]))
    assert _dumps(seen["port"]) == _dumps(seen["jax"])
    (want, want_t), (got, got_t) = out
    assert _dumps(got) == _dumps(want)
    assert got_t == want_t


def _batch(name):
    *_, in_specs, (y_shape, y_hi) = MODELS[name]
    rs = np.random.RandomState(len(name))
    xs = [rs.randint(0, hi, shp).astype(np.int32) if hi
          else rs.randn(*shp).astype(np.float32) for shp, hi in in_specs]
    y = (rs.randint(0, y_hi, y_shape).astype(np.int32) if y_hi
         else rs.rand(*y_shape).astype(np.float32))
    return xs, y


@pytest.mark.parametrize("name", sorted(MODELS))
def test_compile_with_search_exports_the_same_strategy_and_trains(name,
                                                                  tmp_path):
    """``compile(search_budget=2)`` with Adam in both packages, each
    exporting its strategy: the files are equal, and one searched step
    from the same parameters gives the same loss."""
    jff, pff = _pair(name, search_budget=2)
    loss = MODELS[name][4]
    jff.config.export_strategy_file = str(tmp_path / "jax.json")
    pff.config.export_strategy_file = str(tmp_path / "port.json")
    jff.compile(JAdam(alpha=1e-3), getattr(J.LossType, loss))
    pff.compile(AdamOptimizer(alpha=1e-3), getattr(P.LossType, loss))
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == want and got["mesh"] == {"data": 1}
    assert pff.search_info["predicted_time"] \
        == jff.search_info["predicted_time"]
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    xs, y = _batch(name)
    jff.fit(xs, y, epochs=1, verbose=False)
    pff.fit(xs, y, epochs=1, verbose=False)
    assert np.isfinite(pff._last_loss)
    np.testing.assert_allclose(pff._last_loss, float(jff._last_loss),
                               rtol=LOSS_RTOL)
