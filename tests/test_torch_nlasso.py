"""The port's legacy solver surface (``repro_torch.core.nlasso``, the
functional ``core.losses``, ``api.CallableLoss`` / ``pd_iteration``)
against the reference's, on the CPU.

  * the reference's ``tests/test_nlasso.py``, ported at its sizes,
  * ``nlasso`` / ``nlasso_continuation`` / ``solve_nlasso`` against
    ``repro.core.nlasso`` on the same seeded instance: final ``w`` within
    1e-4, objective trace within rtol 1e-4; ``pd_step`` within 1e-6 a
    step; the functional losses and ``make_prox`` within 1e-6; the
    certificate within 1e-5,
  * the reference's ``tests/test_api.py`` adapter tests, ported,
  * ``CallableLoss``: the pallas backend runs it unfused, the sharded
    backends refuse it.

The card's tests of this surface are in ``test_torch_legacy_cuda.py``
(no JAX there: the card's machine has none).
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import losses as JL                          # noqa: E402
from repro.core import nlasso as jn                          # noqa: E402
from repro.data.synthetic import make_sbm_regression as j_sbm  # noqa: E402
from repro_torch.api import (CallableLoss, Problem, Solver,   # noqa: E402
                             SolverConfig, SquaredLoss, pd_iteration)
from repro_torch.api import backends                         # noqa: E402
from repro_torch.api.regularizers import TotalVariation      # noqa: E402
from repro_torch.core import baselines                       # noqa: E402
from repro_torch.core import losses as L                     # noqa: E402
from repro_torch.core.graph import chain_graph               # noqa: E402
from repro_torch.core.nlasso import (NLassoResult,           # noqa: E402
                                     SolverState, nlasso,
                                     nlasso_continuation, pd_step,
                                     primal_dual_gap_certificate,
                                     solve_nlasso)
from repro_torch.data.synthetic import (make_classification_sbm,  # noqa: E402
                                        make_sbm_regression)
from repro_torch.kernels import ops                          # noqa: E402

SBM = dict(seed=0, cluster_sizes=(40, 40), p_in=0.5, p_out=1e-3,
           num_labeled=16)
DATA_FIELDS = ("x", "y", "sample_mask", "labeled_mask")


@pytest.fixture(scope="module")
def sbm():
    # reduced paper setup: 2 clusters x 40 nodes, m_i = 5, n = 2
    return make_sbm_regression(**SBM, device="cpu")


@pytest.fixture(scope="module")
def jsbm(sbm):
    """The reference's instance from the same seed (arrays bit-equal)."""
    jds = j_sbm(**SBM)
    for f in DATA_FIELDS:
        np.testing.assert_array_equal(getattr(sbm.data, f).numpy(),
                                      np.asarray(getattr(jds.data, f)))
    for f in ("src", "dst", "weights", "inc_edges", "inc_signs"):
        np.testing.assert_array_equal(getattr(sbm.graph, f).numpy(),
                                      np.asarray(getattr(jds.graph, f)))
    return jds


def _host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close_results(got, want, *, mse: bool = True):
    np.testing.assert_allclose(_host(got.w), _host(want.w), rtol=0,
                               atol=1e-4)
    assert got.objective.shape == np.asarray(want.objective).shape
    np.testing.assert_allclose(_host(got.objective), _host(want.objective),
                               rtol=1e-4)
    if mse:
        np.testing.assert_allclose(_host(got.mse), _host(want.mse),
                                   rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# the reference's tests/test_nlasso.py, on the port
# ---------------------------------------------------------------------------

def test_objective_monotone_decrease(sbm):
    res = nlasso(sbm.graph, sbm.data, lam=1e-3, num_iters=200,
                 w_true=sbm.w_true)
    obj = res.objective.numpy()
    assert obj[-1] <= obj[10] * 1.01
    assert np.isfinite(obj).all()


@pytest.fixture(scope="module")
def recovered(sbm):
    return nlasso_continuation(sbm.graph, sbm.data, lam=1e-3,
                               warm_iters=1500, final_iters=500,
                               w_true=sbm.w_true)


def test_nlasso_recovers_clustered_weights(sbm, recovered):
    mse = float(recovered.mse[-1])
    assert mse < 5e-2, mse
    w = recovered.w.numpy()
    c0 = w[sbm.clusters == 0].mean(axis=0)
    c1 = w[sbm.clusters == 1].mean(axis=0)
    np.testing.assert_allclose(c0, [2.0, 2.0], atol=0.25)
    np.testing.assert_allclose(c1, [-2.0, 2.0], atol=0.25)


def test_nlasso_beats_pooled_baselines(sbm, recovered):
    """Table-1 ordering: nLasso MSE << pooled LR and CART."""
    w_pool = baselines.pooled_linear_regression(sbm.data)
    lr_mse = baselines.linreg_mse(sbm.data, w_pool, on="test")
    tree_mse = baselines.decision_tree_mse(sbm.data, on="test")
    x, y = sbm.data.x.numpy(), sbm.data.y.numpy()
    pred = np.einsum("vmn,vn->vm", x, recovered.w.numpy())
    lm = sbm.data.labeled_mask.numpy() > 0
    ours = float(np.mean((pred[~lm] - y[~lm]) ** 2))
    assert ours < 0.1 * lr_mse, (ours, lr_mse)
    assert ours < 0.1 * tree_mse, (ours, tree_mse)


def test_dual_feasibility_certificate(sbm):
    lam = 1e-3
    res = nlasso(sbm.graph, sbm.data, lam=lam, num_iters=300)
    cert = primal_dual_gap_certificate(sbm.graph, sbm.data, res.w, res.u,
                                       lam)
    assert float(cert["dual_infeasibility"]) <= 1e-6


def test_dual_iterates_always_feasible(sbm):
    """|u_j^(e)| <= lambda A_e after every iteration (Algorithm 1 step 10)."""
    lam = 5e-3
    res = nlasso(sbm.graph, sbm.data, lam=lam, num_iters=50)
    bound = lam * sbm.graph.weights.numpy()[:, None]
    assert (np.abs(res.u.numpy()) <= bound + 1e-6).all()


def test_pout_sensitivity_direction():
    """Fig. 3: MSE grows as cross-cluster connectivity p_out grows."""
    mses = []
    for p_out in (1e-3, 0.3):
        ds = make_sbm_regression(seed=1, cluster_sizes=(30, 30), p_in=0.5,
                                 p_out=p_out, num_labeled=12, device="cpu")
        res = nlasso_continuation(ds.graph, ds.data, lam=1e-3,
                                  warm_iters=800, final_iters=300,
                                  w_true=ds.w_true)
        mses.append(float(res.mse[-1]))
    assert mses[0] < mses[1], mses


def _high_dim_lasso():
    rng = np.random.default_rng(0)
    V, m, n = 30, 3, 10
    g = chain_graph(rng, V, device="cpu")
    w_true = np.zeros((V, n), np.float32)
    w_true[:, 0] = 2.0
    w_true[:, 1] = -1.0
    x = rng.standard_normal((V, m, n)).astype(np.float32)
    y = np.einsum("vmn,vn->vm", x, w_true)
    labeled = np.zeros(V, np.float32)
    labeled[::2] = 1.0
    return g, x, y, labeled, w_true


def test_lasso_loss_variant_high_dim():
    """§4.2: m_i << n regime — lasso prox recovers sparse weights."""
    g, x, y, labeled, w_true = _high_dim_lasso()
    V, m, _ = x.shape
    data = L.NodeData(x=torch.from_numpy(x), y=torch.from_numpy(y),
                      sample_mask=torch.ones((V, m)),
                      labeled_mask=torch.from_numpy(labeled))
    res = nlasso(g, data, lam=1e-2, num_iters=1200, loss="lasso", alpha=0.02,
                 num_inner=40, rho=1.9, w_true=torch.from_numpy(w_true))
    w = res.w.numpy()
    assert np.abs(w[:, 2:]).mean() < 0.3 * w[:, 0].mean()
    assert w[:, 0].mean() > 1.0
    assert w[:, 1].mean() < -0.4
    assert w[:, 0].mean() < 2.0 + 0.2


def test_logistic_loss_variant_classification():
    """§4.3: networked logistic regression separates the two clusters."""
    ds = make_classification_sbm(seed=0, cluster_sizes=(30, 30),
                                 samples_per_node=10, num_labeled=16,
                                 device="cpu")
    res = nlasso(ds.graph, ds.data, lam=1e-2, num_iters=400,
                 loss="logistic", rho=1.5)
    w = res.w.numpy()
    c0 = w[ds.clusters == 0].mean(axis=0)
    c1 = w[ds.clusters == 1].mean(axis=0)
    assert c0[0] > 0.1 and c1[0] < -0.1
    assert c0[1] > 0.1 and c1[1] > 0.1
    logits = np.einsum("vmn,vn->vm", ds.data.x.numpy(), w)
    pred = (logits > 0).astype(np.float32)
    lm = ds.data.labeled_mask.numpy() > 0
    acc = (pred[~lm] == ds.data.y.numpy()[~lm]).mean()
    assert acc > 0.8, acc


def test_overrelaxation_converges_faster(sbm):
    """Beyond-paper rho=1.9 reaches a lower MSE in the same iterations."""
    base = nlasso(sbm.graph, sbm.data, lam=1e-3, num_iters=400,
                  w_true=sbm.w_true, rho=1.0)
    fast = nlasso(sbm.graph, sbm.data, lam=1e-3, num_iters=400,
                  w_true=sbm.w_true, rho=1.9)
    assert float(fast.mse[-1]) < float(base.mse[-1])


def test_prox_is_firmly_nonexpansive_squared(sbm):
    """||prox(a) - prox(b)|| <= ||a - b|| (resolvent of monotone operator)."""
    prox = L.make_prox("squared", sbm.data, sbm.graph.primal_stepsizes())
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((sbm.data.num_nodes, 2))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((sbm.data.num_nodes, 2))
                         .astype(np.float32))
    lhs = float(torch.linalg.norm(prox(a) - prox(b)))
    rhs = float(torch.linalg.norm(a - b))
    assert lhs <= rhs + 1e-5


# ---------------------------------------------------------------------------
# the port against repro.core.nlasso on the same instance
# ---------------------------------------------------------------------------

FRONT_ENDS = {
    "nlasso_squared": dict(num_iters=150, rho=1.9),
    "nlasso_rho1": dict(num_iters=100),
    "nlasso_lasso": dict(num_iters=60, rho=1.9, loss="lasso", alpha=0.02,
                         num_inner=20),
    "continuation": dict(continuation=True, warm_iters=200,
                         final_iters=100),
}


@pytest.mark.parametrize("case", sorted(FRONT_ENDS))
def test_front_ends_match_reference(sbm, jsbm, case):
    kw = dict(FRONT_ENDS[case])
    if kw.pop("continuation", False):
        want = jn.nlasso_continuation(jsbm.graph, jsbm.data, 1e-3,
                                      w_true=jsbm.w_true, **kw)
        got = nlasso_continuation(sbm.graph, sbm.data, 1e-3,
                                  w_true=sbm.w_true, **kw)
    else:
        want = jn.nlasso(jsbm.graph, jsbm.data, 1e-3, w_true=jsbm.w_true,
                         **kw)
        got = nlasso(sbm.graph, sbm.data, 1e-3, w_true=sbm.w_true, **kw)
    assert isinstance(got, NLassoResult)
    _close_results(got, want)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=0,
                               atol=1e-4)


def test_logistic_front_end_matches_reference():
    from repro.data.synthetic import make_classification_sbm as j_cls
    kw = dict(seed=0, cluster_sizes=(20, 20), samples_per_node=10,
              num_labeled=10)
    jds, ds = j_cls(**kw), make_classification_sbm(**kw, device="cpu")
    want = jn.nlasso(jds.graph, jds.data, 1e-2, num_iters=60,
                     loss="logistic", rho=1.5, num_inner=50)
    got = nlasso(ds.graph, ds.data, 1e-2, num_iters=60, loss="logistic",
                 rho=1.5, num_inner=50)
    assert got.mse is None and want.mse is None
    _close_results(got, want, mse=False)


@pytest.mark.parametrize("with_hooks", [False, True])
def test_solve_nlasso_matches_reference(sbm, jsbm, with_hooks):
    """The deprecated shim with a caller prox (and, with hooks, the
    port's kernel entry points as ``affine_fn`` / ``clip_fn``: their plain
    versions on the CPU), warm-started, with and without ``w_true``."""
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((sbm.data.num_nodes, 2)).astype(np.float32)
    tau = sbm.graph.primal_stepsizes()
    hooks = dict(affine_fn=ops.batched_affine) if with_hooks else {}
    prox = L.make_prox("squared", sbm.data, tau, **hooks)
    jprox = JL.make_prox("squared", jsbm.data, jsbm.graph.primal_stepsizes())
    w0_t = torch.from_numpy(w0.copy())
    with pytest.warns(DeprecationWarning):
        got = solve_nlasso(sbm.graph, sbm.data, prox, 1e-3, 80, w0=w0_t,
                           w_true=sbm.w_true, rho=1.9,
                           clip_fn=ops.tv_prox if with_hooks else None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jn.solve_nlasso(jsbm.graph, jsbm.data, jprox, 1e-3, 80,
                               w0=np.asarray(w0), w_true=jsbm.w_true,
                               rho=1.9)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    # the warm start is read, never written
    np.testing.assert_array_equal(w0_t.numpy(), w0)
    with pytest.warns(DeprecationWarning):
        *_, mse = solve_nlasso(sbm.graph, sbm.data, prox, 1e-3, 10)
    assert mse.shape == (10,) and not mse.any()


def test_pd_step_matches_reference(sbm, jsbm):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((sbm.data.num_nodes, 2)).astype(np.float32)
    u = (1e-3 * rng.uniform(-1, 1, (sbm.graph.num_edges, 2))
         ).astype(np.float32)
    tau, sigma = sbm.graph.primal_stepsizes(), sbm.graph.dual_stepsizes()
    prox = L.make_prox("squared", sbm.data, tau)
    got = pd_step(sbm.graph, prox, 1e-3, tau, sigma,
                  SolverState(torch.from_numpy(w), torch.from_numpy(u)))
    jtau = jsbm.graph.primal_stepsizes()
    want = jn.pd_step(jsbm.graph, JL.make_prox("squared", jsbm.data, jtau),
                      1e-3, jtau, jsbm.graph.dual_stepsizes(),
                      jn.SolverState(w, u))
    assert isinstance(got, SolverState)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=1e-6)
    # pd_iteration is the same step with the regularizer given
    w2, u2 = pd_iteration(sbm.graph, prox, TotalVariation(), 1e-3, tau,
                          sigma, torch.from_numpy(w), torch.from_numpy(u))
    assert torch.equal(w2, got.w) and torch.equal(u2, got.u)


@pytest.mark.parametrize("loss", ["squared", "lasso", "logistic"])
def test_functional_losses_match_reference(sbm, jsbm, loss):
    rng = np.random.default_rng(11)
    w = rng.standard_normal((sbm.data.num_nodes, 2)).astype(np.float32)
    v = rng.standard_normal((sbm.data.num_nodes, 2)).astype(np.float32)
    data, jdata = sbm.data, jsbm.data
    if loss == "logistic":       # labels in {0, 1}
        y = (sbm.data.y.numpy() > 0).astype(np.float32)
        data = dataclasses.replace(data, y=torch.from_numpy(y))
        jdata = dataclasses.replace(jdata, y=y)
    wt = torch.from_numpy(w)
    if loss == "lasso":
        got, want = L.lasso_loss(data, wt, 0.05), JL.lasso_loss(jdata, w,
                                                                0.05)
    else:
        got = getattr(L, f"{loss}_loss")(data, wt)
        want = getattr(JL, f"{loss}_loss")(jdata, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(L.empirical_error(data, wt, loss, alpha=0.05)),
        float(JL.empirical_error(jdata, w, loss, alpha=0.05)), rtol=1e-6)
    tau = sbm.graph.primal_stepsizes()
    prox = L.make_prox(loss, data, tau, alpha=0.05, num_inner=20)
    jprox = JL.make_prox(loss, jdata, jsbm.graph.primal_stepsizes(),
                         alpha=0.05, num_inner=20)
    np.testing.assert_allclose(prox(torch.from_numpy(v)).numpy(),
                               np.asarray(jprox(v)), rtol=0, atol=1e-6)


def test_functional_resolve_matches_reference():
    for args in (("squared",), ("lasso", 0.3, 7), ("logistic", 0.0, 50),
                 ("logistic", 0.0, 5)):
        got, want = L._resolve(*args), JL._resolve(*args)
        assert type(got).__name__ == type(want).__name__
        for f in ("alpha", "num_inner"):
            assert getattr(got, f, None) == getattr(want, f, None), (args, f)
    with pytest.raises(ValueError, match="unknown loss"):
        L._resolve("hinge")


def test_certificate_matches_reference(sbm, jsbm):
    want_res = jn.nlasso(jsbm.graph, jsbm.data, 1e-3, num_iters=100)
    w, u = (torch.from_numpy(np.array(want_res.w)),
            torch.from_numpy(np.array(want_res.u)))
    got = primal_dual_gap_certificate(sbm.graph, sbm.data, w, u, 1e-3)
    want = jn.primal_dual_gap_certificate(jsbm.graph, jsbm.data,
                                          want_res.w, want_res.u, 1e-3)
    assert set(got) == set(want)
    for k in ("dual_infeasibility", "stationarity_residual_labeled"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    # the gap is P(w) - g(u), two float32 sums over the nodes taken in
    # another order (the port's ordered_sum): here 2.1e-5 apart relative,
    # within test_torch_certificate.py's 1e-4 for optimality_gap
    np.testing.assert_allclose(float(got["optimality_gap"]),
                               float(want["optimality_gap"]), rtol=1e-4)


# ---------------------------------------------------------------------------
# the reference's tests/test_api.py adapter tests, on the port
# ---------------------------------------------------------------------------

def _problem(sbm):
    return Problem.create(sbm.graph, sbm.data, 1e-3, device="cpu")


def test_nlasso_adapter_equals_solver(sbm):
    res_old = nlasso(sbm.graph, sbm.data, lam=1e-3, num_iters=120, rho=1.9,
                     w_true=sbm.w_true)
    res_new = Solver(SolverConfig(num_iters=120, rho=1.9)).run(
        _problem(sbm), w_true=sbm.w_true)
    assert torch.equal(res_old.w, res_new.w)
    assert torch.equal(res_old.u, res_new.u)
    assert torch.equal(res_old.mse, res_new.mse)


def test_nlasso_continuation_adapter_equals_solver(sbm):
    res_old = nlasso_continuation(sbm.graph, sbm.data, lam=1e-3,
                                  warm_iters=400, final_iters=200,
                                  w_true=sbm.w_true)
    cfg = SolverConfig(continuation=True, warm_iters=400, final_iters=200,
                       rho=1.9)
    res_new = Solver(cfg).run(_problem(sbm), w_true=sbm.w_true)
    assert torch.equal(res_old.w, res_new.w)


def test_solve_nlasso_shim_warns_and_matches(sbm):
    prox = L.make_prox("squared", sbm.data, sbm.graph.primal_stepsizes())
    with pytest.warns(DeprecationWarning):
        w, u, obj, mse = solve_nlasso(sbm.graph, sbm.data, prox, 1e-3, 100)
    ref = Solver(SolverConfig(num_iters=100)).run(_problem(sbm))
    np.testing.assert_allclose(w.numpy(), ref.w.numpy(), atol=1e-6)
    assert obj.shape == (100,) and mse.shape == (100,)


def test_custom_clip_fn_hook_is_invoked_and_equivalent(sbm):
    """Caller-supplied kernel hooks (legacy nlasso args / SolverConfig
    fields) must actually route the dual clip, not be silently dropped."""
    calls = []

    def my_clip(u, bound):
        calls.append(1)
        return torch.clamp(u, -bound[:, None], bound[:, None])

    res = nlasso(sbm.graph, sbm.data, lam=1e-3, num_iters=60,
                 clip_fn=my_clip)
    assert len(calls) == 60, "custom clip_fn not invoked once a step"
    ref = Solver(SolverConfig(num_iters=60)).run(_problem(sbm))
    np.testing.assert_allclose(res.w.numpy(), ref.w.numpy(), atol=1e-7)
    res2 = Solver(SolverConfig(num_iters=60, clip_fn=my_clip)).run(
        _problem(sbm))
    np.testing.assert_allclose(res2.w.numpy(), ref.w.numpy(), atol=1e-7)


def test_front_ends_solve_on_the_graphs_device(sbm, monkeypatch):
    """The legacy front-ends take no device: they solve where the graph
    lives (here the CPU), never on the default card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = nlasso(sbm.graph, sbm.data, 1e-3, num_iters=5)
    assert res.w.device.type == "cpu"
    cert = primal_dual_gap_certificate(sbm.graph, sbm.data, res.w, res.u,
                                       1e-3)
    assert set(cert) == {"dual_infeasibility",
                         "stationarity_residual_labeled", "optimality_gap"}


# ---------------------------------------------------------------------------
# CallableLoss: unfused under the fused gate, refused by the sharded ones
# ---------------------------------------------------------------------------

def _opaque(sbm):
    prox = L.make_prox("squared", sbm.data, sbm.graph.primal_stepsizes())
    return dataclasses.replace(
        _problem(sbm), loss=CallableLoss(prox_fn=prox, base=SquaredLoss()))


def test_callable_loss_runs_unfused_under_the_fused_gate(sbm, monkeypatch):
    def no_fused(*a, **k):
        raise AssertionError("a CallableLoss reached the fused path")

    monkeypatch.setattr(backends, "_solve_fused", no_fused)
    cfg = SolverConfig(num_iters=40, rho=1.9, backend="pallas", fused=True)
    assert not backends._should_fuse(_opaque(sbm), cfg)
    got = Solver(cfg).run(_opaque(sbm))
    want = Solver(cfg.replace(fused=False)).run(_problem(sbm))
    assert torch.equal(got.w, want.w) and torch.equal(got.u, want.u)
    assert torch.equal(got.objective, want.objective)


@pytest.mark.parametrize("backend", ["sharded", "sharded_fused"])
def test_callable_loss_refused_by_sharded_backends(sbm, backend):
    with pytest.raises(NotImplementedError, match="prox_setup"):
        Solver(SolverConfig(num_iters=10, backend=backend)).run(_opaque(sbm))
