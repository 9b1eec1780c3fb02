"""The port's graph builders and layout planner against the reference.

Both packages plan on the host in numpy, so from one seed every array
must be bit-equal: the generators' edge and incidence arrays, the RCM
order, and every field of ``plan_edge_blocks`` (auto-tuned and at fixed
block sizes).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as jg                              # noqa: E402
from repro.core.partition import rcm_order as j_rcm_order       # noqa: E402
from repro_torch.core import graph as tg                        # noqa: E402
from repro_torch.core.partition import rcm_order as t_rcm_order  # noqa: E402
from repro_torch.interop import graph_from_arrays, layout_from_arrays  # noqa

GRAPH_FIELDS = ("src", "dst", "weights", "inc_edges", "inc_signs")


def _assert_graphs_equal(tgraph, jgraph):
    assert tgraph.num_nodes == jgraph.num_nodes
    for f in GRAPH_FIELDS:
        t = getattr(tgraph, f).numpy()
        j = np.asarray(getattr(jgraph, f))
        assert t.dtype == j.dtype, f
        np.testing.assert_array_equal(t, j, err_msg=f)


def _assert_layouts_equal(tl, jl):
    for f in dataclasses.fields(jl):
        t, j = getattr(tl, f.name), getattr(jl, f.name)
        if isinstance(j, int):
            assert t == j, f.name
        else:
            t, j = t.numpy(), np.asarray(j)
            assert t.dtype == j.dtype, f.name
            np.testing.assert_array_equal(t, j, err_msg=f.name)


def _clustered_6000(mod, seed=0):
    """The scale-out recipe (``benchmarks/scaling.py:_make_clustered``)
    at 6,000 nodes: three ~2000-node clusters, degree ~20.5, ~0.7% of V
    cross edges."""
    v, nc = 6000, 3
    kw = {} if mod is jg else {"device": "cpu"}
    g, _ = mod.sbm_graph_sparse(
        np.random.default_rng(seed), (v // nc,) * nc,
        p_in=20.5 / (v / nc), p_out=2.0 * 0.007 * v / (v * v), **kw)
    return g


@pytest.mark.parametrize("family", ["sbm", "sbm_sparse", "chain",
                                    "build_graph", "grid", "watts_strogatz",
                                    "barabasi_albert"])
def test_generators_match_reference(family):
    def make(mod):
        rng = np.random.default_rng(7)
        kw = {} if mod is jg else {"device": "cpu"}
        if family == "sbm":
            return mod.sbm_graph(rng, (40, 35), 0.3, 0.02, **kw)[0]
        if family == "sbm_sparse":
            return mod.sbm_graph_sparse(rng, (400, 300, 300), 0.02, 1e-4,
                                        **kw)[0]
        if family == "chain":
            return mod.chain_graph(rng, 57, weight=0.5, **kw)
        if family == "grid":
            return mod.grid_graph(rng, 7, 9, weight=0.5, **kw)
        if family == "watts_strogatz":
            return mod.watts_strogatz_graph(rng, 83, k=6, p_rewire=0.2,
                                            **kw)
        if family == "barabasi_albert":
            return mod.barabasi_albert_graph(rng, 120, m=3, **kw)
        edges = rng.integers(0, 90, size=(400, 2))
        edges = edges[edges[:, 0] != edges[:, 1]]
        weights = rng.random(len(edges)).astype(np.float32)
        return mod.build_graph(edges, weights, 90, **kw)

    tgraph, jgraph = make(tg), make(jg)
    _assert_graphs_equal(tgraph, jgraph)
    assert tgraph.structure_hash() == jgraph.structure_hash()
    np.testing.assert_array_equal(tgraph.primal_stepsizes().numpy(),
                                  np.asarray(jgraph.primal_stepsizes()))


def test_graph_operators_match_reference():
    rng = np.random.default_rng(3)
    jgraph, _ = jg.sbm_graph(rng, (30, 30), 0.3, 0.05)
    tgraph = graph_from_arrays(
        **{f: np.asarray(getattr(jgraph, f)) for f in GRAPH_FIELDS},
        num_nodes=jgraph.num_nodes, device="cpu")
    w = rng.standard_normal((60, 3)).astype(np.float32)
    u = rng.standard_normal((jgraph.num_edges, 3)).astype(np.float32)
    tw, tu = torch.from_numpy(w), torch.from_numpy(u)
    np.testing.assert_array_equal(tgraph.incidence_apply(tw).numpy(),
                                  np.asarray(jgraph.incidence_apply(w)))
    np.testing.assert_allclose(
        tgraph.incidence_transpose_apply(tu).numpy(),
        np.asarray(jgraph.incidence_transpose_apply(u)), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(float(tgraph.total_variation(tw)),
                               float(jgraph.total_variation(w)), rtol=1e-6)


@pytest.mark.parametrize("which", ["sbm5", "clustered6000"])
def test_rcm_order_matches_reference(which):
    if which == "sbm5":
        g, _ = jg.sbm_graph(np.random.default_rng(0), (150, 150), 0.5, 1e-3)
    else:
        g = _clustered_6000(jg)
    src = np.asarray(g.src, np.int64)
    dst = np.asarray(g.dst, np.int64)
    for reverse in (True, False):
        np.testing.assert_array_equal(
            t_rcm_order(src, dst, g.num_nodes, reverse=reverse),
            j_rcm_order(src, dst, g.num_nodes, reverse=reverse))


@pytest.mark.parametrize("which", ["sbm5", "clustered6000"])
@pytest.mark.parametrize("hint", [None, (2, 6, 4, 1 << 62)])
def test_plan_edge_blocks_autotuned_bit_equal(which, hint):
    if which == "sbm5":
        jgraph, _ = jg.sbm_graph(np.random.default_rng(0), (150, 150),
                                 0.5, 1e-3)
        tgraph, _ = tg.sbm_graph(np.random.default_rng(0), (150, 150),
                                 0.5, 1e-3, device="cpu")
    else:
        jgraph, tgraph = _clustered_6000(jg), _clustered_6000(tg)
    jl = jg.plan_edge_blocks(jgraph, window_hint=hint)
    tl = tg.plan_edge_blocks(tgraph, window_hint=hint)
    _assert_layouts_equal(tl, jl)
    if which == "clustered6000":
        # the auto-tuner really chose among the ladder's banded rungs
        assert jl.num_blocks > 1


@pytest.mark.parametrize("block_nodes", [16, 32, 64])
def test_plan_edge_blocks_fixed_bit_equal(block_nodes):
    jgraph, _ = jg.sbm_graph(np.random.default_rng(1), (100, 100), 0.1,
                             0.01)
    tgraph, _ = tg.sbm_graph(np.random.default_rng(1), (100, 100), 0.1,
                             0.01, device="cpu")
    jl = jg.plan_edge_blocks(jgraph, block_nodes=block_nodes)
    tl = tg.plan_edge_blocks(tgraph, block_nodes=block_nodes)
    assert jl.num_blocks > 1 and jl.kn > 1
    _assert_layouts_equal(tl, jl)
    for nf, pf in ((1, 0), (2, 6)):
        assert tl.window_bytes(nf, pf) == jl.window_bytes(nf, pf)


def test_layout_carried_across_from_reference():
    """``interop.layout_from_arrays`` rebuilds a reference layout field
    for field, at the port's dtypes."""
    jgraph, _ = jg.sbm_graph(np.random.default_rng(2), (60, 60), 0.2, 0.02)
    jl = jg.plan_edge_blocks(jgraph, block_nodes=32)
    fields = {f.name: getattr(jl, f.name) for f in dataclasses.fields(jl)}
    tl = layout_from_arrays(
        {k: v if isinstance(v, int) else np.asarray(v)
         for k, v in fields.items()}, device="cpu")
    _assert_layouts_equal(tl, jl)
