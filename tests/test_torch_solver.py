"""The port's ``Solver.run`` against the reference's, on the CPU.

Same inputs (the paper's §5 instance from one seed, carried across as
numpy arrays), same ``SolverConfig``: final ``w`` within atol 1e-4 and
the objective trace within rtol 1e-4 (the cross-backend tolerances of
``tests/test_conformance.py``: same iteration, another summation order),
the residual trace and the eq.-11 diagnostics within rtol 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Problem as JProblem                   # noqa: E402
from repro.api import Solver as JSolver                     # noqa: E402
from repro.api import SolverConfig as JConfig               # noqa: E402
from repro.data.synthetic import make_sbm_regression as j_make  # noqa: E402
from repro_torch.api import Problem, Solver, SolverConfig   # noqa: E402
from repro_torch.api import backends                        # noqa: E402
from repro_torch.data.synthetic import make_sbm_regression  # noqa: E402
from repro_torch.interop import problem_from_arrays, state_from_arrays  # noqa
from repro_torch.kernels import ops, ref                    # noqa: E402

GRAPH_FIELDS = ("src", "dst", "weights", "inc_edges", "inc_signs")
DATA_FIELDS = ("x", "y", "sample_mask", "labeled_mask")
BASE = dict(num_iters=200, metric_every=50, rho=1.9)

CASES = {
    "dense": dict(BASE, backend="dense"),
    "fused": dict(BASE, backend="pallas", fused=True),
    "fused_residual": dict(BASE, backend="pallas", fused=True,
                           record_residual=True),
    "dense_continuation": dict(BASE, backend="dense", continuation=True,
                               warm_iters=300, final_iters=200),
    "fused_continuation": dict(BASE, backend="pallas", fused=True,
                               continuation=True, warm_iters=300,
                               final_iters=200),
    "unfused": dict(BASE, backend="pallas", fused=False),
    "unfused_continuation": dict(BASE, backend="pallas", fused=False,
                                 continuation=True, warm_iters=300,
                                 final_iters=200),
}


def _port_problem(jds):
    """The port's Problem on the CPU from the reference dataset's arrays."""
    g, d = jds.graph, jds.data
    return problem_from_arrays(
        {**{f: np.asarray(getattr(g, f)) for f in GRAPH_FIELDS},
         "num_nodes": g.num_nodes},
        {f: np.asarray(getattr(d, f)) for f in DATA_FIELDS},
        1e-3, device="cpu")


def _assert_results_close(got, want):
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-4)
    assert got.objective.shape == np.asarray(want.objective).shape
    np.testing.assert_allclose(got.objective.numpy(),
                               np.asarray(want.objective), rtol=1e-4)
    np.testing.assert_allclose(got.mse.numpy(), np.asarray(want.mse),
                               rtol=1e-4, atol=1e-7)
    if want.residual is None:
        assert got.residual is None
    else:
        np.testing.assert_allclose(got.residual.numpy(),
                                   np.asarray(want.residual), rtol=1e-3)
    assert set(got.diagnostics) == set(want.diagnostics)
    for k, v in want.diagnostics.items():
        # dual_infeasibility sits at 0 (a saturated edge) up to float
        # resolution, so it gets an absolute floor beside the rtol
        np.testing.assert_allclose(float(got.diagnostics[k]), float(v),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


def test_port_dataset_matches_reference():
    jds = j_make(seed=0)
    tds = make_sbm_regression(seed=0, device="cpu")
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(tds.graph, f).numpy(),
                                      np.asarray(getattr(jds.graph, f)))
    for f in DATA_FIELDS:
        np.testing.assert_array_equal(getattr(tds.data, f).numpy(),
                                      np.asarray(getattr(jds.data, f)))
    np.testing.assert_array_equal(tds.w_true.numpy(), np.asarray(jds.w_true))
    np.testing.assert_array_equal(tds.labeled_nodes, jds.labeled_nodes)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_matches_reference(case):
    jds = j_make(seed=0)
    cfg = CASES[case]
    want = JSolver(JConfig(**cfg)).run(
        JProblem.create(jds.graph, jds.data, 1e-3), w_true=jds.w_true)
    got = Solver(SolverConfig(**cfg)).run(
        _port_problem(jds), w_true=torch.from_numpy(np.array(jds.w_true)))
    _assert_results_close(got, want)


def test_multi_block_fused_solve_matches_reference():
    """nb > 1: a 2-cluster SBM of 200 nodes on a 32-node block layout
    (halo windows, one launch per iteration)."""
    jds = j_make(seed=0, cluster_sizes=(100, 100))
    jgraph = jds.graph.with_layout(block_nodes=32)
    assert jgraph.layout.num_blocks > 1 and jgraph.layout.kn > 1
    tp = _port_problem(jds)
    tp = type(tp)(graph=tp.graph.with_layout(block_nodes=32), data=tp.data,
                  lam=tp.lam)
    cfg = CASES["fused"]
    want = JSolver(JConfig(**cfg)).run(
        JProblem.create(jgraph, jds.data, 1e-3), w_true=jds.w_true)
    got = Solver(SolverConfig(**cfg)).run(
        tp, w_true=torch.from_numpy(np.array(jds.w_true)))
    _assert_results_close(got, want)


def test_warm_start_carried_from_reference():
    """A reference solve's state, carried across as numpy arrays, warm
    starts the port's fused solve as it warm starts the reference's
    (the dual rows go through the layout's edge_pos / edge_flip)."""
    jds = j_make(seed=0)
    jp = JProblem.create(jds.graph, jds.data, 1e-3)
    warm = JSolver(JConfig(**CASES["dense"])).run(jp.with_lam(1e-2))
    u0 = jp.regularizer.project_dual(warm.u, jp.graph, jp.lam)
    cfg = CASES["fused"]
    want = JSolver(JConfig(**cfg)).run(jp, w0=warm.w, u0=u0,
                                       w_true=jds.w_true)
    w0, u0 = state_from_arrays(np.asarray(warm.w), np.asarray(u0),
                               device="cpu")
    got = Solver(SolverConfig(**cfg)).run(
        _port_problem(jds), w0=w0, u0=u0,
        w_true=torch.from_numpy(np.array(jds.w_true)))
    _assert_results_close(got, want)


@pytest.mark.parametrize("loss,reg", [("squared", "tv"), ("squared", "tv2"),
                                      ("logistic", "tv"),
                                      ("lasso", "tv2")])
def test_resolve_kernel_hooks(loss, reg):
    """The pallas backend fills unset hooks with the port's kernels (the
    clip for TV only, the affine map for the squared loss only); the
    dense backend fills none; config hooks always win."""
    ds = make_sbm_regression(seed=0, cluster_sizes=(20, 20), num_labeled=8,
                             device="cpu")
    problem = Problem.create(ds.graph, ds.data, 1e-3, loss=loss,
                             regularizer=reg, device="cpu")
    cfg = SolverConfig()
    clip_fn, affine_fn = backends.resolve_kernel_hooks(problem, cfg, True)
    assert clip_fn is (ops.tv_prox if reg == "tv" else None)
    assert affine_fn is (ops.batched_affine if loss == "squared" else None)
    assert backends.resolve_kernel_hooks(problem, cfg, False) == (None, None)

    def mine(*args):
        raise AssertionError("not called here")

    hooked = cfg.replace(clip_fn=mine, affine_fn=mine)
    for use_pallas in (True, False):
        assert backends.resolve_kernel_hooks(problem, hooked,
                                             use_pallas) == (mine, mine)


@pytest.mark.parametrize("hook", ["clip_fn", "affine_fn"])
def test_config_hook_disables_fusion_and_runs(hook):
    """A caller's hook turns the fused gate off even with fused=True, and
    it is the hook that runs, once per iteration."""
    ds = make_sbm_regression(seed=0, cluster_sizes=(20, 20), num_labeled=8,
                             device="cpu")
    problem = Problem.create(ds.graph, ds.data, 1e-3, device="cpu")
    calls = []
    plain = {"clip_fn": ref.tv_prox_ref,
             "affine_fn": ref.batched_affine_ref}[hook]

    def mine(*args):
        calls.append(hook)
        return plain(*args)

    base = SolverConfig(backend="pallas", fused=True, num_iters=30, rho=1.9)
    cfg = base.replace(**{hook: mine})
    assert backends._should_fuse(problem, base)
    assert not backends._should_fuse(problem, cfg)
    got = Solver(cfg).run(problem)
    assert calls == [hook] * 30
    want = Solver(base.replace(fused=False)).run(problem)
    np.testing.assert_array_equal(got.w.numpy(), want.w.numpy())


def test_loss_kwargs_cross_over_and_lasso_matches_reference():
    """``problem_from_arrays`` carries a named loss's kwargs (the lasso's
    ``alpha`` and ``num_inner``) across, and that lasso problem solves on
    the unfused path as the reference's does."""
    from repro_torch.api import LassoLoss

    jds = j_make(seed=0)
    kw = dict(alpha=0.02, num_inner=30)
    g, d = jds.graph, jds.data
    tp = problem_from_arrays(
        {**{f: np.asarray(getattr(g, f)) for f in GRAPH_FIELDS},
         "num_nodes": g.num_nodes},
        {f: np.asarray(getattr(d, f)) for f in DATA_FIELDS}, 1e-3,
        loss="lasso", device="cpu", **kw)
    assert tp.loss == LassoLoss(**kw)
    cfg = CASES["unfused"]
    want = JSolver(JConfig(**cfg)).run(
        JProblem.create(g, d, 1e-3, loss="lasso", **kw), w_true=jds.w_true)
    got = Solver(SolverConfig(**cfg)).run(
        tp, w_true=torch.from_numpy(np.array(jds.w_true)))
    _assert_results_close(got, want)
