"""PyTorch port, the PCG degree/spec round-trips (``parallel/pcg.py``),
the mesh's rank layout (``machine.Mesh``) and the per-rank batch rows
(``distributed.local_batch_rows``) against the JAX package, in one
process.

- ``shape_from_partition_spec`` / ``spec_to_degrees`` /
  ``replicated_shape``: the JAX package's ``tests/test_pcg_parallel_ops.py``
  cases, and each result equal to the JAX package's on the same
  arguments.
- Rank r of a mesh holds what JAX's device r holds: ``Mesh.coords``
  against ``make_mesh``'s device array, and each rank's block of a
  sharded dim (``Mesh.block_index``) and its batch rows against
  ``NamedSharding.devices_indices_map``, for the asymmetric
  ``{"data": 4, "model": 2}`` and a 3-axis mesh, tuple entries in both
  orders.
- ``local_batch_rows`` in a process without a group, as the JAX
  package's one process: the whole batch.
- The parallel ops' forced layouts (``apply_strategy``) equal the JAX
  package's, with its two refusals.
"""

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import flexflow_tpu as J
from flexflow_tpu import distributed as jdist
from flexflow_tpu.machine import make_mesh as j_make_mesh
from flexflow_tpu.parallel import pcg as jpcg
from flexflow_tpu.parallel import strategy as jstrategy
import flexflow_tpu_torch as P
from flexflow_tpu_torch import distributed
from flexflow_tpu_torch.machine import make_mesh
from flexflow_tpu_torch.parallel import pcg
from flexflow_tpu_torch.parallel import strategy as pstrategy
from flexflow_tpu_torch.parallel.comm import norm_spec
from flexflow_tpu_torch.optimizers import SGDOptimizer

MESHES = [{"data": 4, "model": 2}, {"data": 2, "model": 2, "seq": 2},
          {"model": 2, "data": 4}]


def _as_tuple(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def test_spec_roundtrip():
    mesh = make_mesh(8, {"data": 4, "model": 2})
    pts = pcg.ParallelTensorShape((
        pcg.ParallelDim(64, 4, ("data",)), pcg.ParallelDim(128),
        pcg.ParallelDim(256, 2, ("model",)),
    ))
    assert pts.partition_spec() == ("data", None, "model")
    back = pcg.shape_from_partition_spec((64, 128, 256),
                                         pts.partition_spec(), mesh)
    assert back.degrees == (4, 1, 2)
    assert back.sizes == (64, 128, 256)
    assert pts.total_degree == 8


def test_replica_dim_dropped_from_spec():
    pts = pcg.ParallelTensorShape((
        pcg.ParallelDim(4, 4, ("data",), is_replica_dim=True),
        pcg.ParallelDim(32), pcg.ParallelDim(64),
    ))
    assert pts.partition_spec() == (None, None)
    assert pts.sizes == (32, 64)
    assert pts.num_replica == 4


def test_invalid_degree():
    with pytest.raises(ValueError):
        pcg.ParallelDim(10, 4, ("data",))


@pytest.mark.parametrize("shape,spec", [
    ((64, 32), ("data",)), ((64, 32), None), ((64, 32), (("data", "model"),)),
    ((64, 32, 16), ("data", None, "model")), ((8, 6), (("model", "data"),)),
])
def test_spec_to_degrees_matches_jax(shape, spec):
    mesh = make_mesh(8, {"data": 4, "model": 2})
    jmesh = j_make_mesh(8, {"data": 4, "model": 2})
    jspec = JP(*spec) if spec is not None else None
    assert pcg.spec_to_degrees(shape, spec, mesh) == \
        jpcg.spec_to_degrees(shape, jspec, jmesh)
    got = pcg.shape_from_partition_spec(shape, spec, mesh)
    want = jpcg.shape_from_partition_spec(shape, jspec, jmesh)
    assert [(d.size, d.degree, d.mesh_axes) for d in got.dims] == \
        [(d.size, d.degree, d.mesh_axes) for d in want.dims]
    assert pcg.replicated_shape(shape).degrees == \
        jpcg.replicated_shape(shape).degrees


@pytest.mark.parametrize("axes", MESHES)
def test_rank_r_holds_what_jax_device_r_holds(axes):
    n = int(np.prod(list(axes.values())))
    mesh, jmesh = make_mesh(n, axes), j_make_mesh(n, axes)
    devs = list(jmesh.devices.flat)
    for r in range(n):
        idx = np.argwhere(jmesh.devices == devs[r])[0]
        assert mesh.coords(r) == dict(zip(jmesh.axis_names, idx.tolist()))
    names = list(axes)
    specs = [(names[0],), (names[-1],), (tuple(names[:2]),),
             (tuple(reversed(names[:2])),)]
    for spec in specs:
        e = spec[0]
        sh = NamedSharding(jmesh, JP(e))
        parts = int(np.prod([axes[a] for a in
                             (e if isinstance(e, tuple) else (e,))]))
        imap = sh.devices_indices_map((parts * 3,))
        for r, dev in enumerate(jmesh.devices.flat):
            axs = e if isinstance(e, tuple) else (e,)
            # the device's block along the dim
            assert mesh.block_index(axs, r) * 3 == (imap[dev][0].start or 0)
            rows, off = distributed.local_batch_rows(
                distributed.Sharding(mesh, spec), parts * 6, rank=r)
            assert (rows, off) == (6, 2 * (imap[dev][0].start or 0))


def test_group_members_share_the_other_coordinates():
    mesh = make_mesh(8, {"data": 4, "model": 2})
    assert mesh.members(("model",), 5) == (4, 5)
    assert mesh.members(("data",), 5) == (1, 3, 5, 7)
    assert mesh.members(("data", "model"), 5) == tuple(range(8))
    assert norm_spec(("data", ("model", "seq"), None), 3, mesh) == \
        (("data",), ("model",), ())


def test_local_batch_rows_without_a_group_is_the_whole_batch():
    """One process (the JAX package's one process; the port with no
    group): every row."""
    mesh, jmesh = make_mesh(8, {"data": 8}), j_make_mesh(8, {"data": 8})
    assert distributed.process_count() == 1
    assert distributed.local_batch_rows(
        distributed.Sharding(mesh, ("data",)), 64) == \
        jdist.local_batch_rows(NamedSharding(jmesh, JP("data")), 64) == \
        (64, 0)
    assert distributed.allgather_value(3) == jdist.allgather_value(3) == [3]
    x = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    sh = distributed.Sharding(mesh, ("data",))
    np.testing.assert_array_equal(distributed.stage_local_batch(x, sh, 64),
                                  x)
    np.testing.assert_array_equal(
        distributed.all_gather_host(torch.from_numpy(x), sh), x)
    assert distributed.ranks_agree(7) == ([7], True)
    with pytest.raises(ValueError, match="cannot split"):
        distributed.local_batch_rows(distributed.Sharding(mesh, ("data",)),
                                     60, rank=1)


@pytest.mark.parametrize("kind", ["pipeline", "reduction", "named_axis"])
def test_forced_layouts_match_jax(kind):
    """``apply_strategy``'s propagation of the parallel ops' layouts over
    the data-parallel strategy: each op's output spec equals the JAX
    package's."""
    def build(ff, x):
        h = ff.dense(x, 32, name="d1")
        if kind == "pipeline":
            h = ff.repartition(h, dim=0, degree=4, name="rp")
            h = ff.relu(h, name="r")
            h = ff.combine(h, dim=0, degree=4, name="cb")
            h = ff.replicate(h, degree=4, name="rl")
            ff.dense(h, 4, name="d2")
        elif kind == "reduction":
            ff.reduction(h, dim=1, degree=4, name="red")
        else:
            h = ff.repartition(h, dim=1, degree=2, axis="model", name="rp")
            ff.gelu(h, name="g")
    axes = {"data": 4, "model": 2}
    out = []
    for pkg, mm, st_mod in ((J, j_make_mesh, jstrategy),
                            (P, make_mesh, pstrategy)):
        ff = pkg.FFModel(pkg.FFConfig(batch_size=16)) if pkg is J else \
            pkg.FFModel(pkg.FFConfig(batch_size=16), device="cpu")
        build(ff, ff.create_tensor((16, 8), name="x"))
        nodes, _, _ = ff._materialize_nodes()
        mesh = mm(8, axes)
        st = st_mod.data_parallel_strategy(nodes, mesh)
        if pkg is J:
            st_mod.apply_strategy(nodes, st, mesh)
        else:
            st_mod._record_strategy(nodes, st, mesh, kernels="off",
                                    training=True, device="cpu")
        out.append({n.op.name: [_as_tuple(s) if s is not None else None
                                for s in n.output_specs] for n in nodes})
    assert out[0] == out[1]


def test_forced_layout_refusals_match_jax():
    def build(ff, x):
        ff.repartition(ff.dense(x, 32, name="d1"), dim=0, degree=2,
                       name="rp")
    for pkg, mm, st_mod in ((J, j_make_mesh, jstrategy),
                            (P, make_mesh, pstrategy)):
        ff = pkg.FFModel(pkg.FFConfig(batch_size=16)) if pkg is J else \
            pkg.FFModel(pkg.FFConfig(batch_size=16), device="cpu")
        build(ff, ff.create_tensor((16, 8), name="x"))
        nodes, _, _ = ff._materialize_nodes()
        mesh = mm(8, {"data": 4, "model": 2})
        st = st_mod.data_parallel_strategy(nodes, mesh)
        with pytest.raises(ValueError, match="repartition degree 2"):
            if pkg is J:
                st_mod.apply_strategy(nodes, st, mesh)
            else:
                st_mod._record_strategy(nodes, st, mesh, kernels="off",
                                        training=True, device="cpu")


def test_parallel_ops_are_their_values_on_one_device():
    """On one device the four ops compute what the JAX package's do:
    the identity, and the Reduction's replica-group sums; training
    through them runs."""
    ff = P.FFModel(P.FFConfig(batch_size=16), device="cpu")
    x_t = ff.create_tensor((16, 8), name="x")
    h = ff.dense(x_t, 32, name="d1")
    h = ff.repartition(h, dim=0, degree=1, name="rp")
    h = ff.combine(h, dim=0, degree=1, name="cb")
    h = ff.replicate(h, degree=1, name="rl")
    ff.reduction(h, dim=1, degree=4, name="red")
    ff.compile(SGDOptimizer(lr=0.01), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    rs = np.random.RandomState(0)
    x = rs.randn(16, 8).astype(np.float32)
    out = ff.predict(x)
    k, b = ff.get_parameter("d1"), ff.get_parameter("d1", "bias")
    np.testing.assert_allclose(out, (x @ k + b).reshape(16, 4, 8).sum(1),
                               rtol=1e-5, atol=1e-5)
    ff.fit(x, rs.randn(16, 8).astype(np.float32), epochs=1, verbose=False)
    assert np.isfinite(ff._last_loss)
