"""The port's lambda paths against the reference's, and the lane axis of
its kernels.

``repro.api.solve_path`` sweeps one problem over a lambda path with
``jax.vmap``: the fixed-budget sweep vmaps the dense engine or the fused
one, the tol sweep is a residual-triggered cascade and a masked while
loop.  The port writes the lane axis out (``repro_torch.api.solve_path``).
On the CPU, on ``sbm_regression`` (seed 0, smoke size), the same inputs
go through both:

  * the dense, unfused and fused ``pallas`` fixed-budget sweeps: every
    lane's ``w`` within 1e-4 of the reference's, its objective trace
    within rtol 1e-4 (the cross-backend tolerances of
    ``tests/test_conformance.py``);
  * the masked tol sweep on the reference's ``TOL_CONF``, lambdas and
    budgets (``tests/test_engine.py``): per-lane stopping iterations
    equal to the reference's, frozen lanes left bit for bit as they
    stopped, each lane against a single tol solve from the same start
    (same iteration, ``w`` within 1e-6), no block after the last lane's
    stop (a counting block function), and one device->host fetch for
    the sweep;
  * the plain versions of the three kernels with a lane axis against L
    one-lane calls: bit-identical (each lane's arithmetic is the one-lane
    arithmetic).

On the card (``-m cuda``; they skip here): each lane kernel against its
plain version, and against L one-lane launches (bit-identical: the lane
loop keeps the one-lane sum order).
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import SolverConfig, backends, solve_path  # noqa: E402
from repro_torch.core.graph import plan_edge_blocks             # noqa: E402
from repro_torch.engine import loop                             # noqa: E402
from repro_torch.kernels import ops                             # noqa: E402
from repro_torch.kernels.pd_step import fused_pd_step           # noqa: E402
from repro_torch.kernels.ref import (batched_affine_ref,        # noqa: E402
                                     fused_pd_step_ref, tv_prox_ref)
from repro_torch.scenarios import get_scenario                  # noqa: E402

LANE_SCENARIOS = ["sbm_regression", "sparse_lasso", "clustered_logistic",
                  "laplacian_smoothing"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


# ---------------------------------------------------------------------------
# The kernels' lane axis
# ---------------------------------------------------------------------------

def _lane_step(name, lanes, *, dtype=torch.float32, device="cpu",
               block_nodes=None, seed=0):
    """One fused step of ``lanes`` lambdas on scenario ``name``'s layout,
    as the fused path sweeps them: shared prox parameters, tau and sigma;
    each lane its own la = lam_l A_e (lam_l from 1x to 0.1x the
    scenario's) and a state that moves (w ~ 2 N(0, 1), each dual uniform
    in its box)."""
    problem = get_scenario(name).build(seed=0, smoke=True,
                                       device=device).problem
    lt = plan_edge_blocks(problem.graph, block_nodes=block_nodes)
    (params_s, pkeys, _, tau_s, _, sig2, src2, dst2, la2, _) = \
        backends._fused_setup(problem.graph, problem.data, problem.lam,
                              None, loss=problem.loss,
                              reg=problem.regularizer, layout=lt,
                              dtype=dtype)
    rng = np.random.default_rng(seed)
    n = problem.num_features
    scale = torch.from_numpy(np.geomspace(1.0, 0.1, lanes).astype(
        np.float32)).to(device)
    la = (scale[:, None, None] * la2).contiguous()
    w0 = torch.from_numpy(2.0 * rng.standard_normal(
        (lanes, lt.nodes_pad, n))).float().to(device)
    u0 = torch.from_numpy(rng.uniform(-1.0, 1.0, (lanes, lt.edges_pad, n))
                          ).float().to(device) * la
    w_store, u_store = backends._fused_stores(lt, w0, u0, dtype)
    args = [w_store, u_store, lt.pad_node_store(lt.inc_edges),
            lt.pad_node_store(lt.inc_signs), params_s, tau_s, src2, dst2,
            sig2, la]
    kw = dict(loss=problem.loss, reg=problem.regularizer, pkeys=pkeys,
              block_nodes=lt.block_nodes, block_edges=lt.block_edges,
              kn=lt.kn, klo=lt.klo, khi=lt.khi, rho=1.9,
              compute_residual=True, incidence=lt.compact)
    return args, kw


def _lane(args, lane):
    """The one-lane arguments of lane ``lane``."""
    out = list(args)
    out[0], out[1], out[9] = args[0][lane], args[1][lane], args[9][lane]
    return out


def _plain(args, kw, **more):
    kw = {k: v for k, v in kw.items() if k != "incidence"}
    return fused_pd_step_ref(*args, **kw, **more)


def _kernel(args, kw, **more):
    return fused_pd_step(*args[:2], *args[4:], **kw, **more)


@pytest.mark.parametrize("name", LANE_SCENARIOS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [1, 4])
def test_plain_fused_lanes_equal_one_lane_calls(name, dtype, iters):
    """fused_pd_step_ref over L = 3 lanes: each lane's outputs and
    residual are those of a one-lane call on its inputs, bit for bit (a
    banded layout for one step, the whole-graph block for four)."""
    args, kw = _lane_step(name, 3, dtype=getattr(torch, dtype),
                          block_nodes=16 if iters == 1 else None)
    got = _plain(args, kw, iters=iters)
    assert got[0].shape[0] == got[1].shape[0] == got[2].shape[0] == 3
    for lane in range(3):
        one = _plain(_lane(args, lane), kw, iters=iters)
        for g, o in zip(got, one):
            assert torch.equal(g[lane], o)


def test_plain_fused_lanes_in_place_and_stop_word():
    """Lane-stacked ``out`` = the owned rows of the stores (a view with a
    lane stride): updated in place as L one-lane calls would; a clear
    stop word leaves every lane as it was."""
    args, kw = _lane_step("sbm_regression", 3, block_nodes=16)
    want = _plain(args, kw)
    nodes, edges = want[0].shape[1], want[1].shape[1]
    lo = kw["klo"] * kw["block_edges"]
    w_store, u_store = args[0].clone(), args[1].clone()
    out = (w_store[:, :nodes], u_store[:, lo:lo + edges])
    stopped = _plain([w_store, u_store, *args[2:]], kw, out=out,
                     active=torch.zeros(1, dtype=torch.bool))
    assert torch.equal(w_store, args[0]) and torch.equal(u_store, args[1])
    assert torch.equal(stopped[2], torch.zeros(3))
    got = _plain([w_store, u_store, *args[2:]], kw, out=out,
                 active=torch.ones(1, dtype=torch.bool))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(w_store[:, :nodes], want[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_tv_prox_lanes_equal_one_lane_calls(dtype):
    gen = torch.Generator().manual_seed(0)
    u = torch.randn((3, 50, 2), generator=gen).to(getattr(torch, dtype))
    bound = torch.rand((3, 50), generator=gen)
    for lane in range(3):
        assert torch.equal(tv_prox_ref(u, bound)[lane],
                           tv_prox_ref(u[lane], bound[lane]))
        assert torch.equal(ops.tv_prox(u, bound)[lane],
                           tv_prox_ref(u[lane], bound[lane]))


def test_plain_batched_affine_lanes_equal_one_lane_calls():
    """P shared by every lane (a lambda path) or one per lane (a batch of
    problems)."""
    gen = torch.Generator().manual_seed(0)
    p = torch.randn((30, 3, 3), generator=gen)
    p_lanes = torch.randn((4, 30, 3, 3), generator=gen)
    v = torch.randn((4, 30, 3), generator=gen)
    for lane in range(4):
        assert torch.equal(batched_affine_ref(p, v)[lane],
                           batched_affine_ref(p, v[lane]))
        assert torch.equal(batched_affine_ref(p_lanes, v)[lane],
                           batched_affine_ref(p_lanes[lane], v[lane]))
        assert torch.equal(ops.batched_affine(p, v)[lane],
                           batched_affine_ref(p, v[lane]))


def test_wrapper_checks_lane_shapes_before_the_device():
    """The lane axis's shapes are checked before the device check: a
    per-lane ``la`` must carry the lanes."""
    args, kw = _lane_step("sbm_regression", 3)
    with pytest.raises(ValueError, match="CUDA"):
        _kernel(args, kw)
    bad = list(args)
    bad[9] = args[9][0]
    with pytest.raises(ValueError, match="la"):
        _kernel(bad, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", LANE_SCENARIOS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [1, 5])
def test_cuda_fused_lanes_match_one_lane_launches(name, dtype, iters):
    """One launch over L = 3 lanes against three one-lane launches on the
    lanes' inputs: bit-identical outputs and residuals."""
    _need_card()
    args, kw = _lane_step(name, 3, dtype=getattr(torch, dtype),
                          device="cuda",
                          block_nodes=16 if iters == 1 else None)
    got = _kernel(args, kw, iters=iters)
    ones = [_kernel(_lane(args, lane), kw, iters=iters)
            for lane in range(3)]
    torch.cuda.synchronize()
    for lane, one in enumerate(ones):
        for g, o in zip(got, one):
            assert torch.equal(g[lane], o), (name, dtype, iters, lane)


@pytest.mark.cuda
@pytest.mark.parametrize("name", LANE_SCENARIOS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_lanes_match_plain_version(name, dtype):
    """One launch over three lanes against the plain version over three
    lanes, in place with a lane-strided ``out``: 1e-5 in float32; one
    bf16 ulp at each output's scale in bfloat16, and that ulp over
    min(tau, sigma) on each lane's residual."""
    _need_card()
    args, kw = _lane_step(name, 3, dtype=getattr(torch, dtype),
                          device="cuda", block_nodes=16)
    want = _plain(args, kw)
    nodes, edges = want[0].shape[1], want[1].shape[1]
    lo = kw["klo"] * kw["block_edges"]
    w_store, u_store = args[0].clone(), args[1].clone()
    got = _kernel([w_store, u_store, *args[2:]], kw,
                  out=(w_store[:, :nodes], u_store[:, lo:lo + edges]))
    torch.cuda.synchronize()
    g = [t.float().cpu().numpy() for t in got]
    w = [t.float().cpu().numpy() for t in want]
    if dtype == "float32":
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        return
    for a, b in zip(g[:2], w[:2]):
        assert np.abs(a - b).max() <= _bf16_ulp(float(np.abs(b).max()))
    ulp = _bf16_ulp(max(float(np.abs(x).max()) for x in w[:2]))
    tau, sigma = args[5], args[8]
    steps = min(float(tau[tau > 0].min()), float(sigma.min()))
    np.testing.assert_allclose(g[2], w[2], rtol=1e-5, atol=ulp / steps)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tv_prox_lanes(dtype):
    """tv_prox over four lanes, each with its bounds: equal to the plain
    version and to four one-lane launches, bit for bit."""
    _need_card()
    from repro_torch.kernels.tv_prox import tv_prox

    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.randn((4, 1001, 3), generator=gen, device="cuda").to(
        getattr(torch, dtype))
    bound = torch.rand((4, 1001), generator=gen, device="cuda")
    got = tv_prox(u, bound)
    assert torch.equal(got, tv_prox_ref(u, bound))
    for lane in range(4):
        assert torch.equal(got[lane], tv_prox(u[lane].contiguous(),
                                              bound[lane].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
def test_cuda_batched_affine_lanes(shared):
    """batched_affine over four lanes, P shared or per lane: within 1e-5
    of the plain version and bit-identical to four one-lane launches."""
    _need_card()
    from repro_torch.kernels.ridge_prox import batched_affine

    gen = torch.Generator(device="cuda").manual_seed(0)
    v = torch.randn((4, 999, 5), generator=gen, device="cuda")
    p = torch.randn((999, 5, 5) if shared else (4, 999, 5, 5),
                    generator=gen, device="cuda")
    got = batched_affine(p, v)
    np.testing.assert_allclose(got.cpu().numpy(),
                               batched_affine_ref(p, v).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    for lane in range(4):
        pl = p if shared else p[lane].contiguous()
        assert torch.equal(got[lane], batched_affine(pl, v[lane].contiguous()))


# ---------------------------------------------------------------------------
# solve_path against the reference
# ---------------------------------------------------------------------------

PATH_LAMS = (1e-3, 3e-3, 1e-2)
PATH_BASE = dict(rho=1.9, warm_iters=300, final_iters=200, metric_every=10)
PATHS = {"dense": dict(backend="dense"),
         "pallas_unfused": dict(backend="pallas", fused=False),
         "pallas_fused": dict(backend="pallas", fused=True)}
# the reference's masked-sweep settings (tests/test_engine.py): from zero
# inits the last lane stops at 1930, from the cascade's starts at 190;
# the tol engines run no block after the stop, so the budgets cost only
# the blocks the lanes need
TOL_CONF = dict(num_iters=4000, rho=1.9, metric_every=10, tol=5e-3)
TOL_PATH = dict(TOL_CONF, final_iters=2000)
TOL_LAMS = (0.3, 0.003, 0.1, 0.03)

_reference: dict = {}


def _reference_path(path: str, lams, lam: float, **conf):
    """The reference's solve_path on sbm_regression (seed 0, smoke), once
    per configuration."""
    import jax.numpy as jnp
    from repro.api import SolverConfig as JConfig
    from repro.api import solve_path as j_solve_path
    from repro.scenarios import get_scenario as j_get

    key = (path, lams, lam, tuple(sorted(conf.items())))
    if key not in _reference:
        inst = j_get("sbm_regression").build(seed=0, smoke=True, lam=lam)
        _reference[key] = j_solve_path(
            inst.problem, jnp.asarray(lams, jnp.float32),
            JConfig(**conf, **PATHS[path]), w_true=inst.w_true)
    return _reference[key]


def _port(lam):
    inst = get_scenario("sbm_regression").build(seed=0, smoke=True,
                                                lam=lam, device="cpu")
    return inst.problem, inst.w_true


@pytest.fixture
def lane_calls(monkeypatch):
    """Counts the kernel entry points' calls by their lane count."""
    calls = []
    for name, lanes_of in (("tv_prox", lambda a: a[0]),
                           ("batched_affine", lambda a: a[1]),
                           ("pd_step", lambda a: a[0])):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, _lanes_of=lanes_of, **kw):
            t = _lanes_of(a)
            calls.append((_name, t.shape[0] if t.ndim == 3 else 1))
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("path", sorted(PATHS))
def test_fixed_budget_path_matches_reference(path, lane_calls):
    """Every lane within 1e-4 of the reference's on ``w`` and rtol 1e-4
    on the objective trace and MSE; the kernels see every lane at once."""
    want = _reference_path(path, PATH_LAMS, 1e-3, **PATH_BASE)
    problem, w_true = _port(1e-3)
    got = solve_path(problem, PATH_LAMS, SolverConfig(**PATH_BASE,
                                                      **PATHS[path]),
                     w_true=w_true)
    L = len(PATH_LAMS)
    assert got.w.shape == (L, problem.num_nodes, problem.num_features)
    np.testing.assert_allclose(got.lam.numpy(), PATH_LAMS, rtol=1e-6)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-4)
    for name in ("objective", "mse"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape == (L, 20)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7)
    assert set(got.diagnostics) == set(want.diagnostics)
    for k, v in want.diagnostics.items():
        assert got.diagnostics[k].shape == (L,)
    np.testing.assert_allclose(got.diagnostics["dual_infeasibility"].numpy(),
                               np.asarray(want.diagnostics[
                                   "dual_infeasibility"]), atol=1e-6)
    lanes = {n for n, l in lane_calls if l == L}
    assert lanes == {"dense": set(), "pallas_unfused": {"tv_prox",
                                                        "batched_affine"},
                     "pallas_fused": {"pd_step"}}[path]


def test_fused_path_launches_once_per_step_for_every_lane(lane_calls):
    """The fused lanes: one plain-version call per step of the final
    phase for all lanes (the warm solve's calls are one-lane)."""
    cfg = SolverConfig(**PATH_BASE, **PATHS["pallas_fused"])
    problem, _ = _port(1e-3)
    solve_path(problem, PATH_LAMS, cfg)
    lanes = [l for n, l in lane_calls if n == "pd_step"]
    assert lanes.count(len(PATH_LAMS)) == cfg.final_iters // 10
    assert lanes.count(1) == cfg.warm_iters // 10


def test_fused_path_launches_lane_groups_in_order(lane_calls, monkeypatch):
    """More lambdas than one launch takes (``MAX_LANES``, patched to 2
    here): each step launches the lanes in groups of at most two, every
    group in lane order, and the path equals the one launched whole,
    bit for bit (lanes are independent)."""
    from repro_torch.kernels import pd_step

    cfg = SolverConfig(**PATH_BASE, **PATHS["pallas_fused"])
    problem, w_true = _port(1e-3)
    lams = (1e-3, 2e-3, 3e-3, 5e-3, 1e-2)
    whole = solve_path(problem, lams, cfg, w_true=w_true)
    lane_calls.clear()
    monkeypatch.setattr(pd_step, "MAX_LANES", 2)
    got = solve_path(problem, lams, cfg, w_true=w_true)
    lanes = [l for n, l in lane_calls if n == "pd_step"]
    steps = cfg.final_iters // 10
    assert lanes[-3 * steps:] == [2, 2, 1] * steps
    for name in ("w", "u", "objective", "mse"):
        assert torch.equal(getattr(got, name), getattr(whole, name)), name


@pytest.mark.parametrize("path", ["dense", "pallas_unfused"])
def test_tol_sweep_matches_reference(path):
    """The masked sweep (cascade, then every lane stopping on its own
    residual): per-lane stopping iterations equal to the reference's,
    ``w`` within 1e-4, traces truncated to the last block any lane ran,
    each stopped lane's last residual <= tol, fewer iterations than the
    fixed budget would pay."""
    conf = TOL_PATH
    want = _reference_path(path, TOL_LAMS, 1e-2, **conf)
    problem, w_true = _port(1e-2)
    got = solve_path(problem, TOL_LAMS, SolverConfig(**conf, **PATHS[path]),
                     w_true=w_true)
    iters = got.diagnostics["iterations"]
    np.testing.assert_array_equal(iters,
                                  np.asarray(want.diagnostics["iterations"]))
    assert len(set(iters.tolist())) > 1, "lambdas should stop differently"
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-4)
    blocks = int(iters.max()) // conf["metric_every"]
    assert got.objective.shape == got.residual.shape == (4, blocks)
    np.testing.assert_allclose(got.objective.numpy(),
                               np.asarray(want.objective), rtol=1e-4)
    for lane in range(4):
        stop = int(iters[lane]) // conf["metric_every"] - 1
        assert float(got.residual[lane, stop]) <= conf["tol"]
        assert not got.residual[lane, stop + 1:].any()     # frozen: 0
    assert int(iters.sum()) < 4 * conf["final_iters"]


def _sweep(problem, lams, w0_b, u0_b, budget, **hooks):
    from repro_torch.api.solver import _masked_sweep_impl

    params = problem.loss.prox_setup(problem.data,
                                     problem.graph.primal_stepsizes())
    return _masked_sweep_impl(
        problem, np.asarray(lams, np.float32), w0_b, u0_b, None, params,
        TOL_CONF["tol"], num_iters=budget, rho=TOL_CONF["rho"],
        metric_every=TOL_CONF["metric_every"], clip_fn=hooks.get("clip_fn"),
        affine_fn=hooks.get("affine_fn"))


def test_masked_sweep_lanes_match_single_solves():
    """From zero inits: every lane stops at the iteration of a single tol
    solve from the same init (and of the reference's masked sweep), with
    ``w`` within 1e-6 of it; and each frozen lane (every lane but the
    last to stop) is left bit for bit as it was at its stop (a sweep cut
    at that lane's stop holds the same state)."""
    import jax.numpy as jnp
    from repro.api.solver import _masked_sweep as j_sweep
    from repro.scenarios import get_scenario as j_get
    from repro_torch.api.backends import _solve_dense

    problem, _ = _port(1e-2)
    V, n, E = problem.num_nodes, problem.num_features, problem.graph.num_edges
    L, budget = len(TOL_LAMS), TOL_CONF["num_iters"]
    zeros = (torch.zeros((L, V, n)), torch.zeros((L, E, n)))
    w_b, u_b, _, iters_b, blocks = _sweep(problem, TOL_LAMS, *zeros, budget)
    iters = iters_b.numpy()
    assert int(blocks) == int(iters.max()) // TOL_CONF["metric_every"]

    jp = j_get("sbm_regression").build(seed=0, smoke=True, lam=1e-2).problem
    jparams = jp.loss.prox_setup(jp.data, jp.graph.primal_stepsizes())
    _, _, _, j_iters, _ = j_sweep(
        jp.graph, jp.data, jnp.asarray(TOL_LAMS, jnp.float32),
        jnp.zeros((L, V, n)), jnp.zeros((L, E, n)), None, jparams,
        TOL_CONF["tol"], loss=jp.loss, reg=jp.regularizer, num_iters=budget,
        rho=TOL_CONF["rho"], metric_every=TOL_CONF["metric_every"],
        clip_fn=None, affine_fn=None)
    np.testing.assert_array_equal(iters, np.asarray(j_iters))

    single_cfg = SolverConfig(**TOL_CONF)
    for lane, lam in enumerate(TOL_LAMS):
        s = _solve_dense(problem.with_lam(float(np.float32(lam))),
                         single_cfg)
        assert s.diagnostics["iterations"] == int(iters[lane]), lam
        np.testing.assert_allclose(w_b[lane].numpy(), s.w.numpy(), rtol=0,
                                   atol=1e-6)
        if iters[lane] < iters.max():
            cut = _sweep(problem, TOL_LAMS, *zeros, int(iters[lane]))
            assert torch.equal(cut[0][lane], w_b[lane])
            assert torch.equal(cut[1][lane], u_b[lane])


def test_masked_sweep_runs_no_block_after_the_last_stop(monkeypatch):
    """A counting block function: the sweep advances its lanes once a
    block up to the last lane's stop and not after; its plain version
    (``device_loop_plain``) advances them for the whole budget and leaves
    the same lanes, traces of the blocks run and stops, bit for bit."""
    from repro_torch.api import solver

    problem, _ = _port(1e-2)
    V, n, E = problem.num_nodes, problem.num_features, problem.graph.num_edges
    # a budget of 2000: past the last stop (1930), and the plain loop
    # below computes all of it
    L, budget = len(TOL_LAMS), 2000
    zeros = (torch.zeros((L, V, n)), torch.zeros((L, E, n)))
    calls = []
    real = solver._path_lane_fns

    def counted(*a, **kw):
        advance, metrics = real(*a, **kw)

        def advance_counted(state):
            calls.append(1)
            return advance(state)
        return advance_counted, metrics

    monkeypatch.setattr(solver, "_path_lane_fns", counted)
    w_b, u_b, traces, iters_b, blocks = _sweep(problem, TOL_LAMS, *zeros,
                                               budget)
    nb = int(blocks)
    assert len(calls) == nb == int(iters_b.max()) // TOL_CONF[
        "metric_every"] < budget // TOL_CONF["metric_every"]
    calls.clear()
    monkeypatch.setattr(solver, "device_loop", loop.device_loop_plain)
    plain = _sweep(problem, TOL_LAMS, *zeros, budget)
    assert len(calls) == budget // TOL_CONF["metric_every"]
    assert torch.equal(plain[0], w_b) and torch.equal(plain[1], u_b)
    assert torch.equal(plain[3], iters_b) and int(plain[4]) == nb
    for got, want in zip(traces, plain[2]):
        assert torch.equal(got[:nb], want[:nb])


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Make every implicit host read of a tensor raise."""
    def refuse(*_args, **_kwargs):
        raise AssertionError("a tensor was read on the host during the "
                             "sweep")
    with monkeypatch.context() as m:
        for name in ("item", "__bool__", "__float__", "__int__", "tolist"):
            m.setattr(torch.Tensor, name, refuse)
        yield


@pytest.mark.parametrize("path", ["dense", "pallas_unfused"])
def test_tol_sweep_fetches_once(path, monkeypatch):
    """The masked sweep makes one device->host fetch (its block count and
    per-lane iterations) and reads nothing else on the host; with the
    warm solve, itself a tol solve, ``solve_path`` makes two."""
    from repro_torch.api import solver

    problem, _ = _port(1e-2)
    cfg = SolverConfig(**TOL_PATH, compute_diagnostics=False, **PATHS[path])
    fetched = []
    real_masked = solver._solve_path_masked

    def masked(*a, **kw):
        before = loop.device_fetch.calls
        with _no_host_reads(monkeypatch):
            out = real_masked(*a, **kw)
        fetched.append(loop.device_fetch.calls - before)
        return out

    monkeypatch.setattr(solver, "_solve_path_masked", masked)
    before = loop.device_fetch.calls
    with _no_host_reads(monkeypatch):
        got = solve_path(problem, TOL_LAMS, cfg)
    assert fetched == [1]
    assert loop.device_fetch.calls - before == 2
    assert got.diagnostics["iterations"].shape == (4,)
    # a fixed-budget sweep fetches nothing
    before = loop.device_fetch.calls
    solve_path(problem, TOL_LAMS, cfg.replace(tol=None, warm_iters=100,
                                              final_iters=100))
    assert loop.device_fetch.calls == before


def test_path_refusals():
    problem, _ = _port(1e-3)
    with pytest.raises(ValueError, match="non-empty 1-D"):
        solve_path(problem, [])
    with pytest.raises(NotImplementedError,
                       match="backend must be 'dense' or 'pallas', got "
                             "'sharded'"):
        solve_path(problem, PATH_LAMS, SolverConfig(backend="sharded"))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        solve_path(problem, PATH_LAMS,
                   SolverConfig(**PATH_BASE, dtype="bfloat16"))


# ---------------------------------------------------------------------------
# The path metrics: every lane in one evaluation
# ---------------------------------------------------------------------------

@pytest.fixture
def metric_calls(monkeypatch):
    """Counts the evaluations of the squared loss's empirical error (one
    per metric function call, whatever its lane count)."""
    from repro_torch.api.losses import SquaredLoss

    calls = []
    real = SquaredLoss.empirical_error

    def counted(self, data, w):
        calls.append(w.shape[0] if w.ndim == 3 else 1)
        return real(self, data, w)

    monkeypatch.setattr(SquaredLoss, "empirical_error", counted)
    return calls


@pytest.mark.parametrize("path", sorted(PATHS))
def test_path_metrics_evaluate_every_lane_at_once(path, metric_calls):
    """A fixed-budget path evaluates its trace metrics once a metric
    block for all its lanes (the reference vmaps them), not once a lane:
    one call over every lane per block of the final phase, after the warm
    solve's one-lane calls."""
    problem, w_true = _port(1e-3)
    cfg = SolverConfig(**PATH_BASE, **PATHS[path],
                       compute_diagnostics=False)  # no per-lane certificate
    got = solve_path(problem, PATH_LAMS, cfg, w_true=w_true)
    warm, final = (cfg.warm_iters // cfg.metric_every,
                   cfg.final_iters // cfg.metric_every)
    assert metric_calls == [1] * warm + [len(PATH_LAMS)] * final
    assert got.objective.shape == (len(PATH_LAMS), final)


def test_masked_sweep_evaluates_every_lane_at_once(metric_calls):
    """The masked tol sweep: one metrics call over every lane a block."""
    problem, _ = _port(1e-2)
    V, n, E = problem.num_nodes, problem.num_features, problem.graph.num_edges
    L = len(TOL_LAMS)
    zeros = (torch.zeros((L, V, n)), torch.zeros((L, E, n)))
    _, _, _, _, blocks = _sweep(problem, TOL_LAMS, *zeros, 400)
    assert metric_calls == [L] * int(blocks)


def _per_lane_formula(problem, lam, w, w_true):
    """The one-problem trace formula as the earlier slices wrote it (a
    matrix product for the predictions, library sums): objective and
    eq.-24 MSE of one lane."""
    data, graph = problem.data, problem.graph
    pred = torch.einsum("vmn,vn->vm", data.x, w)
    node = (torch.sum((data.y - pred) ** 2 * data.sample_mask, dim=1)
            / data.counts())
    obj = (torch.sum(node * data.labeled_mask)
           + problem.regularizer.value(graph, w, lam))
    sq = torch.sum((w - w_true) ** 2, dim=1)
    mse = torch.sum(torch.where(data.labeled_mask == 0, sq,
                                torch.zeros_like(sq))) / w.shape[0]
    return obj, mse


@pytest.mark.parametrize("reg", ["tv", "tv2"])
def test_lane_metrics_match_the_per_lane_formula(reg):
    """``backends.lane_metrics`` over four lanes against the per-lane
    formula (rtol 1e-6: sums in another order), and each lane bit for bit
    the one-lane evaluation the lane's own solve records
    (``make_metrics_fn``)."""
    from repro_torch.api.regularizers import get_regularizer

    problem, w_true = _port(1e-3)
    problem = dataclasses.replace(problem, regularizer=get_regularizer(reg))
    lams = (1e-3, 3e-3, 1e-2, 3e-2)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal(
        (len(lams),) + tuple(w_true.shape)).astype(np.float32))
    g = problem.graph
    obj, mse = backends.lane_metrics(
        problem.loss, problem.regularizer, g.src, g.dst, g.weights,
        problem.data, backends.lane_values(lams, "cpu"), w_true)(w)
    assert obj.shape == mse.shape == (len(lams),)
    for k, lam in enumerate(lams):
        want = _per_lane_formula(problem, float(np.float32(lam)), w[k],
                                 w_true)
        np.testing.assert_allclose(obj[k].item(), want[0].item(), rtol=1e-6)
        np.testing.assert_allclose(mse[k].item(), want[1].item(), rtol=1e-6)
        one = backends.make_metrics_fn(problem.loss, problem.regularizer, g,
                                       problem.data, float(np.float32(lam)),
                                       w_true)(w[k])
        assert torch.equal(one[0], obj[k]) and torch.equal(one[1], mse[k])


def test_lane_metrics_in_lane_groups_equal_one_group(monkeypatch):
    """Lanes whose gathers pass ``LANE_METRICS_ELEMENTS`` are evaluated
    in groups of lanes: the same bits as one group, for a path's shared
    graph and for ``solve_many``'s stacked graphs and data."""
    from repro_torch.core.losses import NodeData

    problem, w_true = _port(1e-3)
    g, data = problem.graph, problem.data
    lams = backends.lane_values((1e-3, 3e-3, 1e-2, 3e-2, 0.1), "cpu")
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal(
        (5,) + tuple(w_true.shape)).astype(np.float32))
    stacked = NodeData(*(torch.stack([getattr(data, k)] * 5)
                         for k in ("x", "y", "sample_mask", "labeled_mask")))
    cases = [(g.src, g.dst, g.weights, data, w_true),
             (torch.stack([g.src] * 5), torch.stack([g.dst] * 5),
              torch.stack([g.weights] * 5), stacked, None)]
    for src, dst, weights, d, truth in cases:
        def run():
            return backends.lane_metrics(problem.loss, problem.regularizer,
                                         src, dst, weights, d, lams,
                                         truth)(w)
        whole = run()
        per_lane = max(src.shape[-1] * w.shape[-1],
                       data.x.shape[-3] * data.x.shape[-2])
        monkeypatch.setattr(backends, "LANE_METRICS_ELEMENTS", 2 * per_lane)
        grouped = run()
        monkeypatch.undo()
        for a, b in zip(whole, grouped):
            assert torch.equal(a, b)
