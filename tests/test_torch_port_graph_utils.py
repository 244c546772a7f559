"""PyTorch port, ``utils/graph_algorithms.py`` and ``utils/dot.py`` against
the JAX package's.

- The seven cases of ``tests/test_utils_graph.py::TestGraphAlgorithms``
  on the port's own copy, each also giving the JAX package's result
  exactly (the same order, sets, node and hash).
- ``--compgraph PATH`` (``export_strategy_computation_graph_file``): the
  port's ``compile`` writes the strategy's Graphviz file, byte for byte
  the JAX package's for the MLP built from one layer counter, with and
  without ``--include-costs-dot-graph``, and with a searched strategy's
  predicted-time note.
"""

import pytest

import flexflow_tpu as J
from flexflow_tpu.ffconst import ActiMode as JActi
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.tensor import Tensor as JTensor
from flexflow_tpu.utils import graph_algorithms as jga
import flexflow_tpu_torch as P
from flexflow_tpu_torch.ffconst import ActiMode
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.optimizers import SGDOptimizer
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.utils import graph_algorithms as pga
from flexflow_tpu_torch.utils.graph_algorithms import (
    DisjointSet, dominators, hash_combine, immediate_post_dominator,
    post_dominators, topo_sort)

# diamond: a -> b, a -> c, b -> d, c -> d, d -> e
DIAMOND = {"a": ["b", "c"], "b": ["d"], "c": ["d"], "d": ["e"], "e": []}


class TestGraphAlgorithms:
    def test_topo_sort(self):
        order = topo_sort(DIAMOND)
        pos = {n: i for i, n in enumerate(order)}
        assert pos["a"] < pos["b"] < pos["d"] < pos["e"]
        assert pos["a"] < pos["c"] < pos["d"]
        assert order == jga.topo_sort(DIAMOND)

    def test_topo_sort_cycle(self):
        with pytest.raises(ValueError):
            topo_sort({"a": ["b"], "b": ["a"]})

    def test_dominators(self):
        dom = dominators(DIAMOND, "a")
        assert dom["d"] == {"a", "d"}  # neither b nor c dominates d
        assert dom["b"] == {"a", "b"}
        assert dom["e"] == {"a", "d", "e"}
        assert dom == jga.dominators(DIAMOND, "a")

    def test_post_dominators_find_bottleneck(self):
        pdom = post_dominators(DIAMOND, "e")
        # d post-dominates everything: it is the sequence-split point
        assert "d" in pdom["a"] and "d" in pdom["b"] and "d" in pdom["c"]
        assert immediate_post_dominator(DIAMOND, "b", "e") == "d"
        assert immediate_post_dominator(DIAMOND, "d", "e") == "e"
        assert pdom == jga.post_dominators(DIAMOND, "e")
        assert pga.reversed_graph(DIAMOND) == jga.reversed_graph(DIAMOND)

    def test_disjoint_set(self):
        ds = DisjointSet()
        ds.union(1, 2)
        ds.union(3, 4)
        assert ds.same(1, 2) and not ds.same(2, 3)
        ds.union(2, 3)
        assert ds.same(1, 4)

    def test_hash_combine_deterministic(self):
        h1 = hash_combine(hash_combine(0, "linear"), (64, 128))
        h2 = hash_combine(hash_combine(0, "linear"), (64, 128))
        h3 = hash_combine(hash_combine(0, "linear"), (64, 256))
        assert h1 == h2 != h3
        assert h1 == jga.hash_combine(jga.hash_combine(0, "linear"),
                                      (64, 128))

    def test_immediate_post_dominator_of_a_chain(self):
        chain = {"x": ["y"], "y": ["z"], "z": []}
        assert immediate_post_dominator(chain, "x", "z") == "y"
        assert immediate_post_dominator(chain, "z", "z") is None
        assert immediate_post_dominator(chain, "x", "z") \
            == jga.immediate_post_dominator(chain, "x", "z")


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


def _mlp(pkg, cfg):
    ff = (pkg.FFModel(cfg) if pkg is J
          else pkg.FFModel(cfg, device="cpu"))
    act = (JActi if pkg is J else ActiMode).AC_MODE_RELU
    t = ff.create_tensor((16, 32))
    t = ff.dense(t, 64, activation=act)
    t = ff.dense(t, 10)
    ff.softmax(t)
    return ff


@pytest.mark.parametrize("costs,budget", [(False, 0), (True, 0), (True, 2)],
                         ids=["plain", "costs", "searched"])
def test_compgraph_writes_the_references_dot_file(tmp_path, costs, budget):
    jpath, ppath = tmp_path / "jax.dot", tmp_path / "port.dot"
    jcfg = J.FFConfig(batch_size=16, workers_per_node=1,
                      search_budget=budget)
    jcfg.export_strategy_computation_graph_file = str(jpath)
    jcfg.include_costs_dot_graph = costs
    pcfg = P.FFConfig()
    rest = pcfg.parse_args(["-b", "16", "--compgraph", str(ppath),
                            "--budget", str(budget)]
                           + (["--include-costs-dot-graph"] if costs
                              else []))
    assert rest == []
    assert pcfg.export_strategy_computation_graph_file == str(ppath)
    assert pcfg.include_costs_dot_graph is costs
    starts = _starts()
    jff = _mlp(J, jcfg)
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    pff = _mlp(P, pcfg)
    _settle()
    jff.compile(J.SGDOptimizer(lr=0.01),
                J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    pff.compile(SGDOptimizer(lr=0.01),
                P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    want = jpath.read_text()
    got = ppath.read_text()
    assert got == want
    assert got.startswith("digraph pcg {") and "->" in got
    assert ("|flops " in got) is costs
    assert ("predicted" in got) is (budget > 0)
