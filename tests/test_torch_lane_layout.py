"""The fused lambda path's lane-minor state, on the CPU.

On the card the fused lambda path hands the register tile's lane kernel
lane-minor state: (L, rows, n) views of (rows, L, n) storage, so one
visit to a row reads every lane's (``api/backends.py:_fused_lane_minor``,
``csrc/pd_step_lanes.cuh``).  Here the plain version runs on those views:

  * the fused ``solve_path`` with the layout forced lane-minor gives the
    lane-major run's ``w``, ``u``, traces and residuals bit for bit, and
    every lane is within the cross-backend tolerances of
    ``tests/test_conformance.py`` (1e-4 on ``w``, rtol 1e-4 on the
    objective) of the reference's ``repro.api.solve_path`` through its
    fused pallas path, for the squared, lasso and logistic losses;
  * the wrapper takes a lane-minor view and refuses overlapping or
    mis-strided lanes, before its device check;
  * the layout function picks lane-major off the card, past the register
    tile (n > 16), for one lane, for a launch group of one lane and where
    the staging plan does not fit, and lane-minor otherwise (the plan's
    counts stubbed: the CPU has no kernel library).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import SolverConfig, backends, solve_path  # noqa: E402
from repro_torch.api.losses import get_loss                     # noqa: E402
from repro_torch.kernels import ops, pd_step                    # noqa: E402
from repro_torch.kernels.pd_step import fused_pd_step           # noqa: E402
from repro_torch.scenarios import get_scenario                  # noqa: E402

SCENARIOS = ["sbm_regression", "sparse_lasso", "clustered_logistic"]
LAMS = (1e-3, 3e-3, 1e-2)
CONF = dict(rho=1.9, warm_iters=30, final_iters=30, metric_every=10)


def _reference(name):
    """The reference's fixed-budget fused pallas path on scenario
    ``name`` (seed 0, smoke size)."""
    import jax.numpy as jnp
    from repro.api import SolverConfig as JConfig
    from repro.api import solve_path as j_solve_path
    from repro.scenarios import get_scenario as j_get

    inst = j_get(name).build(seed=0, smoke=True)
    return j_solve_path(inst.problem, jnp.asarray(LAMS, jnp.float32),
                        JConfig(**CONF, backend="pallas", fused=True),
                        w_true=inst.w_true)


@pytest.mark.parametrize("name", SCENARIOS)
def test_lane_minor_path_is_the_lane_major_path(name, monkeypatch):
    inst = get_scenario(name).build(seed=0, smoke=True, device="cpu")
    cfg = SolverConfig(**CONF, backend="pallas", fused=True,
                       record_residual=True)
    major = solve_path(inst.problem, LAMS, cfg, w_true=inst.w_true)
    strides = []
    real = ops.pd_step

    def recorded(*a, **kw):
        if a[0].ndim == 3:
            strides.append((a[0].stride(), a[1].stride(), a[9].stride()))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "pd_step", recorded)
    monkeypatch.setattr(backends, "_fused_lane_minor", lambda *a: True)
    minor = solve_path(inst.problem, LAMS, cfg, w_true=inst.w_true)
    L, n = len(LAMS), inst.problem.num_features
    assert strides and all(w[:2] == (n, L * n) and u[:2] == (n, L * n)
                           and la[:2] == (1, L) for w, u, la in strides)
    for key in ("w", "u", "objective", "mse", "residual"):
        assert torch.equal(getattr(minor, key), getattr(major, key)), key
    want = _reference(name)
    np.testing.assert_allclose(minor.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(minor.objective.numpy(),
                               np.asarray(want.objective), rtol=1e-4,
                               atol=1e-7)


def _step(lanes=3):
    """One fused step's wrapper arguments over ``lanes`` lambdas on the
    §5 scenario's layout, lane-minor, on the CPU."""
    problem = get_scenario("sbm_regression").build(seed=0, smoke=True,
                                                   device="cpu").problem
    lt = backends._graph_layout(problem.graph)
    (params_s, pkeys, _, tau_s, _, sig2, src2, dst2, la2, _) = \
        backends._fused_setup(problem.graph, problem.data,
                              list(np.geomspace(1e-3, 1e-2, lanes)), None,
                              loss=problem.loss, reg=problem.regularizer,
                              layout=lt, lane_minor=True)
    n = problem.num_features
    w0 = torch.randn((lanes, lt.nodes_pad, n),
                     generator=torch.Generator().manual_seed(0))
    w_store, u_store = backends._fused_stores(
        lt, w0, torch.zeros((lanes, lt.edges_pad, n)), torch.float32,
        lane_minor=True)
    args = [w_store, u_store, params_s, tau_s, src2, dst2, sig2, la2]
    kw = dict(loss=problem.loss, reg=problem.regularizer, pkeys=pkeys,
              block_nodes=lt.block_nodes, block_edges=lt.block_edges,
              kn=lt.kn, klo=lt.klo, khi=lt.khi, incidence=lt.compact)
    return args, kw


def test_wrapper_takes_lane_minor_views_before_the_device():
    """Lane-minor state (and lane-minor ``out``: the owned rows) passes
    the wrapper's checks and reaches its device check; lanes that overlap
    or are strided neither way are refused first."""
    args, kw = _step()
    w_store, u_store = args[:2]
    L, rows, n = w_store.shape
    assert w_store.stride() == (n, L * n, 1)
    assert args[7].stride()[:2] == (1, L)
    lo = kw["klo"] * kw["block_edges"]
    out = (w_store[:, :rows - (kw["kn"] - 1) * kw["block_nodes"]],
           u_store[:, lo:lo + args[4].shape[0]])
    with pytest.raises(ValueError, match="CUDA"):
        fused_pd_step(*args, **kw, out=out)
    overlap = w_store[:1].expand(L, rows, n)
    with pytest.raises(ValueError, match="lanes overlap"):
        fused_pd_step(overlap, *args[1:], **kw)
    # rows L n apart, but lanes 2 n apart: neither layout
    gappy = torch.zeros((rows, 2 * L, n))[:, ::2].transpose(0, 1)
    with pytest.raises(ValueError, match="mis-strided"):
        fused_pd_step(gappy, *args[1:], **kw)
    # lanes n apart, rows only n apart: every row of every lane overlaps
    crowded = torch.zeros(rows + L, n).as_strided((L, rows, n), (n, n, 1))
    with pytest.raises(ValueError, match="overlap"):
        fused_pd_step(crowded, *args[1:], **kw)
    with pytest.raises(ValueError, match="la"):
        fused_pd_step(*args[:7], args[7][0], **kw)


def test_layout_function_picks_lane_minor_for_the_lane_kernel(monkeypatch):
    """Lane-minor exactly where every launch is the register tile's
    staged lane kernel on the card."""
    fits = {"staged": True}

    def staging(kind, n, num_samples, lanes=1):
        return (1, 2) if fits["staged"] else (3, 2)

    monkeypatch.setattr(pd_step, "staging_bytes", staging)
    monkeypatch.setattr(pd_step, "streaming_bytes",
                        lambda *a: (1, 2))
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    squared, logistic = get_loss("squared"), get_loss("logistic")
    pick = backends._fused_lane_minor
    cap = pd_step.MAX_LANES
    assert pick(squared, 2, 5, 6, cuda)
    assert pick(logistic, 16, 8, 2, cuda)
    assert pick(squared, 2, 5, cap + 2, cuda)
    assert not pick(squared, 2, 5, 6, cpu)
    assert not pick(squared, 17, 5, 6, cuda)
    assert not pick(squared, 2, 5, 1, cuda)
    assert not pick(squared, 2, 5, cap + 1, cuda)
    fits["staged"] = False                  # the streamed variant runs
    assert not pick(logistic, 2, 8, 6, cuda)
