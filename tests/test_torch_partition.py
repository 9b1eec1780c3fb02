"""The port's shard planners against the reference's, bit for bit.

``repro_torch.core.partition`` keeps its own copy of the reference's
numpy planners (``cluster_partition``, ``block_partition``,
``plan_partition``, ``plan_hierarchy``), so every array of a
``PartitionPlan`` and a ``HierarchyPlan`` must equal the reference's —
values and dtypes — at S = 1, 2, 4 and 8 shards on
``tests/test_distributed.py``'s fixture, and on two zoo scenarios, under
both partitioners.  Also: the permute / unpermute round trips (numpy and
on the tensor's device), the hierarchy's invariants as the reference's
tests state them, and each shard's rows of the sharded problems against
the reference's stacked arrays.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import distributed as j_dist                 # noqa: E402
from repro.core import partition as jp                       # noqa: E402
from repro.data.synthetic import make_sbm_regression as j_sbm  # noqa: E402
from repro.scenarios import get_scenario as j_get            # noqa: E402
from repro_torch.core import distributed as t_dist           # noqa: E402
from repro_torch.core import partition as tp                 # noqa: E402
from repro_torch.data.synthetic import make_sbm_regression   # noqa: E402
from repro_torch.scenarios import get_scenario               # noqa: E402

FIXTURE = dict(seed=3, cluster_sizes=(24, 24), p_in=0.5, p_out=5e-3,
               num_labeled=12)
SHARDS = (1, 2, 4, 8)
PARTITIONERS = ("cluster", "block")
SCENARIOS = ("grid2d", "clustered_logistic")
HINT = (2, 6, 4, 1 << 62)

_pairs: dict = {}


def pair(source: str):
    """(reference graph, data; port graph, data) of a source, once."""
    if source not in _pairs:
        if source == "fixture":
            j, t = j_sbm(**FIXTURE), make_sbm_regression(**FIXTURE,
                                                         device="cpu")
        else:
            j = j_get(source).build(seed=0, smoke=True).problem
            t = get_scenario(source).build(seed=0, smoke=True,
                                           device="cpu").problem
        _pairs[source] = (j.graph, j.data, t.graph, t.data)
    return _pairs[source]


def assignments(source: str, num_shards: int, partitioner: str):
    jg, _, tg, _ = pair(source)
    if partitioner == "cluster":
        return (jp.cluster_partition(jg, num_shards),
                tp.cluster_partition(tg, num_shards))
    return (jp.block_partition(jg.num_nodes, num_shards),
            tp.block_partition(tg.num_nodes, num_shards))


def assert_plans_equal(jplan, tplan):
    assert type(jplan).__name__ == type(tplan).__name__
    for f in dataclasses.fields(jplan):
        a, b = getattr(jplan, f.name), getattr(tplan, f.name)
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray), f.name
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert type(a) is type(b) and a == b, (f.name, a, b)


CASES = ([("fixture", s, p) for s in SHARDS for p in PARTITIONERS]
         + [(name, s, p) for name in SCENARIOS for s in (2, 4)
            for p in PARTITIONERS])


@pytest.mark.parametrize("source,num_shards,partitioner", CASES)
def test_partition_plan_is_the_reference_plan(source, num_shards,
                                              partitioner):
    ja, ta = assignments(source, num_shards, partitioner)
    assert ta.dtype == ja.dtype
    np.testing.assert_array_equal(ta, ja)
    jg, _, tg, _ = pair(source)
    assert_plans_equal(jp.plan_partition(jg, ja, num_shards),
                       tp.plan_partition(tg, ta, num_shards))


@pytest.mark.parametrize("source,num_shards,partitioner", CASES)
def test_hierarchy_plan_is_the_reference_plan(source, num_shards,
                                              partitioner):
    ja, ta = assignments(source, num_shards, partitioner)
    jg, _, tg, _ = pair(source)
    assert_plans_equal(
        jp.plan_hierarchy(jg, ja, num_shards, window_hint=HINT),
        tp.plan_hierarchy(tg, ta, num_shards, window_hint=HINT))


@pytest.mark.parametrize("num_shards", SHARDS)
def test_permute_round_trips(num_shards):
    _, _, g, _ = pair("fixture")
    plan = tp.plan_partition(g, tp.cluster_partition(g, num_shards),
                             num_shards)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((g.num_nodes, 3)).astype(np.float32)
    u = rng.standard_normal((g.num_edges, 3)).astype(np.float32)
    w_p = tp.permute_node_array(plan, w)
    u_p = tp.permute_edge_array(plan, u)
    np.testing.assert_array_equal(
        tp.unpermute_node_array(plan, w_p, g.num_nodes), w)
    np.testing.assert_array_equal(
        tp.unpermute_edge_array(plan, u_p, g.num_edges), u)
    # every real node and edge appears exactly once
    assert sorted(plan.node_perm[plan.node_perm >= 0]) == list(
        range(g.num_nodes))
    assert sorted(plan.edge_perm[plan.edge_perm >= 0]) == list(
        range(g.num_edges))
    # the tensor forms give the numpy forms' bits
    w_t, u_t = torch.from_numpy(w), torch.from_numpy(u)
    w_pt = tp.permute_node_array_device(plan, w_t)
    u_pt = tp.permute_edge_array_device(plan, u_t)
    np.testing.assert_array_equal(w_pt.numpy(), w_p)
    np.testing.assert_array_equal(u_pt.numpy(), u_p)
    assert torch.equal(
        tp.unpermute_node_array_device(plan, w_pt, g.num_nodes), w_t)
    assert torch.equal(
        tp.unpermute_edge_array_device(plan, u_pt, g.num_edges), u_t)


@pytest.fixture(scope="module")
def hier4():
    _, _, g, _ = pair("fixture")
    return tp.plan_hierarchy(g, tp.cluster_partition(g, 4), 4)


def test_hierarchy_ownership_is_a_partition(hier4):
    """Every node and every edge is owned by exactly one shard."""
    h = hier4
    assert sorted(h.node_map[h.node_owned > 0].tolist()) == list(
        range(h.num_nodes))
    assert sorted(h.edge_map[h.edge_owned > 0].tolist()) == list(
        range(h.num_edges))


def test_hierarchy_inject_extract_is_the_identity(hier4):
    """inject -> extract is the identity on node and (oriented) edge
    signals in the stacked store layout."""
    h = hier4
    rng = np.random.default_rng(0)
    w = rng.standard_normal((h.num_nodes, 3)).astype(np.float32)
    w_store = t_dist._hier_gather(h.w_inj, w, 0.0)
    np.testing.assert_array_equal(w_store[h.w_sel], w)
    u = rng.standard_normal((h.num_edges, 3)).astype(np.float32)
    u_store = t_dist._hier_gather(h.u_inj, u, 0.0) * h.u_inj_flip[:, None]
    np.testing.assert_array_equal(u_store[h.u_sel] * h.u_flip[:, None], u)


def test_hierarchy_halo_closure_covers_owned_incidence(hier4):
    """Each shard's local subgraph reproduces D^T u exactly on its owned
    nodes from local storage alone (the 1-hop halo closure that the
    per-iteration dual refresh relies on)."""
    h = hier4
    _, _, g, _ = pair("fixture")
    rng = np.random.default_rng(1)
    u = rng.standard_normal((g.num_edges, 2)).astype(np.float32)
    dtu = np.zeros((g.num_nodes, 2), np.float32)
    np.add.at(dtu, g.src.numpy(), u)
    np.add.at(dtu, g.dst.numpy(), -u)
    NV, ESR = h.nodes_pad, h.u_store_rows
    u_store = t_dist._hier_gather(h.u_inj, u, 0.0) * h.u_inj_flip[:, None]
    for s in range(h.num_shards):
        inc_e = h.inc_edges[s * NV:(s + 1) * NV]
        inc_s = h.inc_signs[s * NV:(s + 1) * NV]
        ust = u_store[s * ESR:(s + 1) * ESR]
        contrib = (ust[inc_e] * inc_s[:, :, None]).sum(axis=1)
        own = h.node_owned[s * NV:(s + 1) * NV] > 0
        gids = h.node_map[s * NV:(s + 1) * NV][own]
        np.testing.assert_allclose(contrib[own], dtu[gids], atol=1e-5)


@pytest.mark.parametrize("loss", ["squared", "logistic"])
@pytest.mark.parametrize("num_shards", (2, 4))
def test_shard_rows_are_the_reference_rows(num_shards, loss):
    """Each shard's rows of the port's sharded problems are its rows of
    the reference's stacked arrays: the tables bit for bit, the prox
    parameters to float32 rounding (two frameworks' prox set-up)."""
    jg, jd, tg, td = pair("fixture" if loss == "squared"
                          else "clustered_logistic")
    jsp = j_dist.shard_problem(jg, jd, num_shards, loss=loss)
    jhp = j_dist.shard_problem_fused(jg, jd, num_shards, loss=loss,
                                     window_hint=HINT)
    vp, ep = jsp.plan.nodes_per_shard, jsp.plan.edges_per_shard
    h = jhp.hier
    WSR, NV, NE = h.w_store_rows, h.nodes_pad, h.edges_pad
    for s in range(num_shards):
        tsp = t_dist.shard_problem(tg, td, num_shards, loss=loss, shard=s)
        rows = slice(s * vp, (s + 1) * vp)
        erows = slice(s * ep, (s + 1) * ep)
        np.testing.assert_array_equal(tsp.tau.numpy(),
                                      np.asarray(jsp.tau)[rows])
        for label, t, j in (("src", tsp.src, jsp.src),
                            ("dst", tsp.dst, jsp.dst),
                            ("bound_unit", tsp.bound_unit, jsp.bound_unit)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j)[erows],
                                          err_msg=label)
        np.testing.assert_array_equal(tsp.send_rows.numpy(),
                                      np.asarray(jsp.send_rows))
        assert sorted(tsp.prox_params) == sorted(jsp.prox_params)
        for k, v in tsp.prox_params.items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jsp.prox_params[k])[rows],
                                       rtol=1e-5, atol=1e-6, err_msg=k)

        thp = t_dist.shard_problem_fused(tg, td, num_shards, loss=loss,
                                         window_hint=HINT, shard=s)
        wrows = slice(s * WSR, (s + 1) * WSR)
        np.testing.assert_array_equal(thp.tau.numpy(),
                                      np.asarray(jhp.tau)[wrows])
        for label in ("inc_edges", "inc_signs"):
            np.testing.assert_array_equal(
                getattr(thp, label).numpy(),
                np.asarray(getattr(jhp, label))[wrows], err_msg=label)
        np.testing.assert_array_equal(
            thp.node_owned.numpy(),
            np.asarray(jhp.node_owned)[s * NV:(s + 1) * NV])
        for label in ("src", "dst", "bound_unit", "edge_owned", "orient"):
            np.testing.assert_array_equal(
                getattr(thp, label).numpy(),
                np.asarray(getattr(jhp, label))[s * NE:(s + 1) * NE],
                err_msg=label)
        for k, v in thp.prox_params.items():
            np.testing.assert_allclose(v.numpy(),
                                       np.asarray(jhp.prox_params[k])[wrows],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        # the compact incidence is the shard layout's padded tables'
        in_ptr, in_ids, out_run = (t.numpy() for t in thp.incidence)
        assert in_ptr.shape == (NV + 1,) and out_run.shape == (NV, 2)
        inc_s = h.inc_signs[s * NV:(s + 1) * NV]
        np.testing.assert_array_equal(np.diff(in_ptr),
                                      (inc_s < 0).sum(axis=1))
        np.testing.assert_array_equal(out_run[:, 1],
                                      (inc_s > 0).sum(axis=1))
        assert len(in_ids) == int((inc_s < 0).sum())
