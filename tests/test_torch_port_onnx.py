"""PyTorch port, the ONNX frontend against the JAX package's.

Every model of ``tests/test_onnx_frontend.py`` goes through both
packages' ``ONNXModel`` (the port on the CPU): the duck-typed
ModelProto stand-ins (MLP, conv/pool/residual, concat/split/transpose)
with the JAX model's parameters carried into the port
(``weights.from_jax_params``), and the wire-format files with
initializers, written by the port's own ``proto`` writer and read by
both packages, each loading the file's weights (``copy_weights_to``).
``predict`` of the two packages agree at the reference test's tolerance
(1e-4 / 1e-5; 1e-3 / 1e-4 for the conv net) and each agrees with torch's
forward of the same weights; after one SGD step (lr 0.01, MSE) the
losses agree at rtol 1e-4.
"""

import types

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.onnx import ONNXModel as JONNXModel
from flexflow_tpu.onnx import proto as jproto
from flexflow_tpu.optimizers import SGDOptimizer as JSGD
import flexflow_tpu_torch as P
from flexflow_tpu_torch.onnx import ONNXModel
from flexflow_tpu_torch.onnx.proto import encode_model, encode_node
from flexflow_tpu_torch.onnx import proto as pproto
from flexflow_tpu_torch.optimizers import SGDOptimizer as PSGD
from flexflow_tpu_torch.weights import from_jax_params

LOSS_RTOL = 1e-4


def attr(name, **kw):
    a = types.SimpleNamespace(name=name, i=None, f=None, s=None,
                              ints=None, floats=None)
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def onnx_node(op_type, inputs, outputs, *attrs):
    return types.SimpleNamespace(op_type=op_type, input=list(inputs),
                                 output=list(outputs), attribute=list(attrs))


def fake_model(nodes):
    graph = types.SimpleNamespace(node=nodes, initializer=[])
    return types.SimpleNamespace(graph=graph)


STAND_INS = {
    "mlp": ([onnx_node("Gemm", ["x"], ["h"], attr("out_dim", i=32)),
             onnx_node("Relu", ["h"], ["h_act"]),
             onnx_node("Gemm", ["h_act"], ["logits"], attr("out_dim", i=4)),
             onnx_node("Softmax", ["logits"], ["probs"], attr("axis", i=-1))],
            (8, 16), (1e-4, 1e-5)),
    "conv_pool_residual": (
        [onnx_node("Conv", ["x"], ["c1"], attr("out_channels", i=4),
                   attr("kernel_shape", ints=[3, 3]),
                   attr("strides", ints=[1, 1]),
                   attr("pads", ints=[1, 1, 1, 1])),
         onnx_node("Relu", ["c1"], ["r1"]),
         onnx_node("Add", ["r1", "c1"], ["res"]),
         onnx_node("MaxPool", ["res"], ["p1"],
                   attr("kernel_shape", ints=[2, 2])),
         onnx_node("Flatten", ["p1"], ["flat"]),
         onnx_node("Gemm", ["flat"], ["out"], attr("out_dim", i=3))],
        (4, 1, 8, 8), (1e-3, 1e-4)),
    "concat_split_transpose": (
        [onnx_node("Split", ["x"], ["a", "b"], attr("axis", i=1),
                   attr("split", ints=[8, 8])),
         onnx_node("Concat", ["a", "b"], ["cat"], attr("axis", i=1)),
         onnx_node("Transpose", ["cat"], ["tr"], attr("perm", ints=[0, 1])),
         onnx_node("ReduceMean", ["tr"], ["m"], attr("axes", ints=[1]),
                   attr("keepdims", i=0))],
        (4, 16), (1e-5, 1e-6)),
}


def _compile(pkg, ff):
    sgd = PSGD if pkg is P else JSGD
    ff.compile(sgd(lr=0.01), pkg.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])


def _model(pkg, shape):
    kw = {"device": "cpu"} if pkg is P else {}
    return pkg.FFModel(pkg.FFConfig(batch_size=shape[0],
                                    only_data_parallel=True,
                                    workers_per_node=1), **kw)


def _hold_and_step(jff, pff, x, tol):
    rtol, atol = tol
    got, want = pff.predict(x), np.asarray(jff.predict(x))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    y = np.random.RandomState(5).randn(*got.shape).astype(np.float32)
    jff.fit(x, y, epochs=1, verbose=False)
    pff.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_allclose(pff._last_loss, float(jff._last_loss),
                               rtol=LOSS_RTOL)
    return got


@pytest.mark.parametrize("name", sorted(STAND_INS))
def test_stand_in_graph_matches_jax(name):
    nodes, shape, tol = STAND_INS[name]
    ffs = []
    for pkg, om in ((J, JONNXModel), (P, ONNXModel)):
        ff = _model(pkg, shape)
        t = ff.create_tensor(shape)
        out = om(fake_model(nodes)).apply(ff, {"x": t})
        _compile(pkg, ff)
        ffs.append((ff, out))
    (jff, jout), (pff, pout) = ffs
    assert pout.shape == jout.shape
    assert [l.op_type.name for l in pff.layers] \
        == [l.op_type.name for l in jff.layers]
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    got = _hold_and_step(jff, pff, x, tol)
    if name == "mlp":
        np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=1e-5)
    if name == "concat_split_transpose":
        np.testing.assert_allclose(got.reshape(-1), x.mean(axis=1),
                                   rtol=1e-5, atol=1e-6)


def _mlp_file():
    torch.manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                            torch.nn.Linear(32, 4))
    nodes = [
        encode_node("Gemm", ["x", "w0", "b0"], ["h"], alpha=1.0, beta=1.0,
                    transB=1),
        encode_node("Relu", ["h"], ["h_act"]),
        encode_node("Gemm", ["h_act", "w1", "b1"], ["out"], alpha=1.0,
                    beta=1.0, transB=1),
    ]
    inits = {"w0": m[0].weight, "b0": m[0].bias, "w1": m[2].weight,
             "b1": m[2].bias}
    data = encode_model(nodes, {k: v.detach().numpy()
                                for k, v in inits.items()},
                        inputs={"x": (8, 16)}, outputs={"out": (8, 4)})
    return data, m, (8, 16), 4, (1e-4, 1e-5)


def _conv_file():
    torch.manual_seed(1)
    conv = torch.nn.Conv2d(3, 8, 3, stride=1, padding=1)
    fc = torch.nn.Linear(8 * 4 * 4, 5)

    def torch_fwd(x):
        h = torch.relu(conv(x))
        h = torch.nn.functional.max_pool2d(h, 2, 2)
        return fc(h.flatten(1))

    nodes = [
        encode_node("Conv", ["x", "cw", "cb"], ["c"], kernel_shape=[3, 3],
                    strides=[1, 1], pads=[1, 1, 1, 1]),
        encode_node("Relu", ["c"], ["r"]),
        encode_node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2],
                    strides=[2, 2]),
        encode_node("Flatten", ["p"], ["f"]),
        encode_node("Gemm", ["f", "fw", "fb"], ["out"], alpha=1.0, beta=1.0,
                    transB=1),
    ]
    inits = {"cw": conv.weight, "cb": conv.bias, "fw": fc.weight,
             "fb": fc.bias}
    data = encode_model(nodes, {k: v.detach().numpy()
                                for k, v in inits.items()},
                        inputs={"x": (4, 3, 8, 8)}, outputs={"out": (4, 5)})
    return data, torch_fwd, (4, 3, 8, 8), 4, (1e-3, 1e-4)


FILES = {"mlp": _mlp_file, "conv_net": _conv_file}


@pytest.mark.parametrize("name", sorted(FILES))
def test_file_with_initializers_matches_jax_and_torch(name):
    """The port writes the file; both packages read it and load its
    weights; both predict torch's forward of those weights."""
    data, fwd, shape, n_arrays, tol = FILES[name]()
    ffs = []
    for pkg, om_cls in ((J, JONNXModel), (P, ONNXModel)):
        om = om_cls(data)
        assert set(om.initializers) == ({"w0", "b0", "w1", "b1"}
                                        if name == "mlp"
                                        else {"cw", "cb", "fw", "fb"})
        ff = _model(pkg, shape)
        t = ff.create_tensor(shape)
        om.apply(ff, {"x": t})
        _compile(pkg, ff)
        assert om.copy_weights_to(ff) == n_arrays
        ffs.append(ff)
    jff, pff = ffs
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    want = fwd(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(pff.predict(x), want, rtol=tol[0],
                               atol=tol[1])
    _hold_and_step(jff, pff, x, tol)


def test_writer_matches_jax_writer_and_both_readers():
    """The port's writer emits the JAX package's bytes; the port's reader
    parses them to the same nodes, attributes and initializer arrays."""
    data, *_ = _conv_file()
    nodes = [jproto.encode_node("Conv", ["x", "cw", "cb"], ["c"],
                                kernel_shape=[3, 3], strides=[1, 1],
                                pads=[1, 1, 1, 1])]
    inits = {"cw": np.arange(8 * 3 * 9, dtype=np.float32).reshape(8, 3, 3, 3),
             "cb": np.zeros(8, np.float32),
             "shp": np.asarray([0, 8], np.int64)}
    want = jproto.encode_model(nodes, inits, inputs={"x": (4, 3, 8, 8)},
                               outputs={"c": (4, 8, 8, 8)})
    got = pproto.encode_model(
        [pproto.encode_node("Conv", ["x", "cw", "cb"], ["c"],
                            kernel_shape=[3, 3], strides=[1, 1],
                            pads=[1, 1, 1, 1])],
        inits, inputs={"x": (4, 3, 8, 8)}, outputs={"c": (4, 8, 8, 8)})
    assert got == want
    for blob in (got, data):
        jm, pm = JONNXModel(blob), ONNXModel(blob)
        assert [(n.op_type, list(n.input), list(n.output))
                for n in pm.model.graph.node] \
            == [(n.op_type, list(n.input), list(n.output))
                for n in jm.model.graph.node]
        assert set(pm.initializers) == set(jm.initializers)
        for k, v in jm.initializers.items():
            np.testing.assert_array_equal(pm.initializers[k], v)
            assert pm.initializers[k].dtype == v.dtype


def test_reshape_and_split_from_constant_inputs():
    nodes = [
        encode_node("Reshape", ["x", "shp"], ["r"]),
        encode_node("Split", ["r", "sizes"], ["a", "b"], axis=1),
        encode_node("Concat", ["b", "a"], ["out"], axis=1),
    ]
    data = encode_model(
        nodes, {"shp": np.asarray([0, 8], dtype=np.int64),
                "sizes": np.asarray([2, 6], dtype=np.int64)},
        inputs={"x": (4, 2, 4)}, outputs={"out": (4, 8)})
    ffs = []
    for pkg, om_cls in ((J, JONNXModel), (P, ONNXModel)):
        ff = _model(pkg, (4, 2, 4))
        t = ff.create_tensor((4, 2, 4))
        out = om_cls(data).apply(ff, {"x": t})
        assert out.shape == (4, 8)
        _compile(pkg, ff)
        ffs.append(ff)
    x = np.random.RandomState(4).randn(4, 2, 4).astype(np.float32)
    want = np.concatenate([x.reshape(4, 8)[:, 2:], x.reshape(4, 8)[:, :2]], 1)
    for ff in ffs:
        np.testing.assert_allclose(np.asarray(ff.predict(x)), want)


def test_batch_norm_statistics_load_into_the_op_state():
    """BatchNormalization's running mean and variance (initializers 3 and
    4) land in the port's op state, as in the JAX package's."""
    c = 4
    rs = np.random.RandomState(6)
    inits = {"cw": rs.randn(c, 3, 3, 3).astype(np.float32),
             "s": rs.rand(c).astype(np.float32) + 0.5,
             "b": rs.randn(c).astype(np.float32),
             "m": rs.randn(c).astype(np.float32),
             "v": rs.rand(c).astype(np.float32) + 0.5}
    nodes = [encode_node("Conv", ["x", "cw"], ["c"], kernel_shape=[3, 3],
                         pads=[1, 1, 1, 1]),
             encode_node("BatchNormalization", ["c", "s", "b", "m", "v"],
                         ["bn"]),
             encode_node("Flatten", ["bn"], ["out"])]
    data = encode_model(nodes, inits, inputs={"x": (2, 3, 4, 4)},
                        outputs={"out": (2, c * 16)})
    ffs = []
    for pkg, om_cls in ((J, JONNXModel), (P, ONNXModel)):
        ff = _model(pkg, (2, 3, 4, 4))
        om = om_cls(data)
        om.apply(ff, {"x": ff.create_tensor((2, 3, 4, 4))})
        _compile(pkg, ff)
        assert om.copy_weights_to(ff) == 5
        ffs.append(ff)
    jff, pff = ffs
    np.testing.assert_array_equal(pff.state["bn"]["mean"].numpy(), inits["m"])
    np.testing.assert_array_equal(pff.state["bn"]["var"].numpy(), inits["v"])
    x = rs.randn(2, 3, 4, 4).astype(np.float32)
    np.testing.assert_allclose(pff.predict(x), np.asarray(jff.predict(x)),
                               rtol=1e-4, atol=1e-5)
