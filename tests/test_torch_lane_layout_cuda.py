"""The register tile's lane kernel of ``fused_pd_step`` on lane-minor
state, on the card (``-m cuda``; every test here skips without one).

The fused lambda path hands the lane kernel (``csrc/pd_step_lanes.cuh``)
lane-minor state: (L, rows, n) views of (rows, L, n) storage
(``api/backends.py:_fused_lane_minor``).  For every loss in float32 and
bfloat16 storage, one and five iterations, lane counts 2, 6, 9 (one past
a chunk of eight lanes at n <= 2) and 37, with 0%, 10% and 100% of the
nodes labeled, on rows aligned to their vectors and on rows one element
off (element-wise loads), a lane-minor launch is

  * bit-identical to one-lane launches on each lane's inputs (each lane
    sums in the one-lane order),
  * bit-identical to the lane-major launch on the same inputs,
  * within STEP_TOL of the plain version over the lanes for one
    iteration in float32 (one bf16 ulp at each output's scale in
    bfloat16), SOLVE_TOL for five (the metric block's limit: float32
    drift between two sum orders grows with the iterations);

and a lane-minor store sent to the wide (n = 17) or the streamed logistic
variant is refused by name.  The fused ``solve_path`` on the card runs
its lane launches on lane-minor stores and gives the bits of the same
path on lane-major ones.  No JAX: these run on the card's machine.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import SolverConfig, backends, solve_path  # noqa: E402
from repro_torch.core.graph import plan_edge_blocks             # noqa: E402
from repro_torch.core.losses import NodeData                    # noqa: E402
from repro_torch.kernels.pd_step import fused_pd_step           # noqa: E402
from repro_torch.kernels.ref import fused_pd_step_ref           # noqa: E402
from repro_torch.scenarios import get_scenario                  # noqa: E402

SCENARIOS = {"squared": "sbm_regression", "lasso": "sparse_lasso",
             "logistic": "clustered_logistic"}
LANES = (2, 6, 9, 37)
SHARES = (0.0, 0.1, 1.0)
STEP_TOL = 1e-5            # kernel vs plain version, one call
SOLVE_TOL = 1e-4           # a five-iteration launch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _problem(loss, share, *, n=None, seed=0):
    """The loss's scenario at smoke size on the card, ``share`` of its
    nodes labeled (drawn from ``seed``); with ``n``, its features
    replaced by ``n`` standard normal ones."""
    problem = get_scenario(SCENARIOS[loss]).build(seed=0, smoke=True,
                                                  device="cuda").problem
    rng = np.random.default_rng(seed)
    data = problem.data
    labeled = torch.from_numpy(
        (rng.random(problem.num_nodes) < share).astype(np.float32)).cuda()
    x = data.x
    if n is not None:
        x = torch.from_numpy(rng.standard_normal(
            tuple(x.shape[:2]) + (n,)).astype(np.float32)).cuda()
    return dataclasses.replace(problem, data=NodeData(
        x=x, y=data.y, sample_mask=data.sample_mask, labeled_mask=labeled))


def _shifted(t):
    """A copy of lane-minor ``t`` whose storage starts one element past an
    aligned allocation: no row is aligned to its vector."""
    lanes, rows, n = t.shape
    flat = torch.empty(rows * lanes * n + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(rows, lanes, n).transpose(0, 1)
    out.copy_(t)
    return out


def _lane_minor(t):
    return t.transpose(0, 1).contiguous().transpose(0, 1)


def _launch_inputs(problem, lanes, dtype, iters, seed=0):
    """Lane-major and lane-minor arguments of one launch over ``lanes``
    lambdas (1x to 0.1x the problem's), from a state that moves (w ~ 2
    N(0, 1), each dual uniform in its box); a banded layout for one
    iteration, the whole-graph block for more."""
    lt = plan_edge_blocks(problem.graph,
                          block_nodes=16 if iters == 1 else None)
    (params_s, pkeys, _, tau_s, _, sig2, src2, dst2, la2, _) = \
        backends._fused_setup(problem.graph, problem.data, problem.lam,
                              None, loss=problem.loss,
                              reg=problem.regularizer, layout=lt,
                              dtype=dtype)
    rng = np.random.default_rng(seed)
    n = problem.num_features
    scale = torch.from_numpy(np.geomspace(1.0, 0.1, lanes).astype(
        np.float32)).cuda()
    la = (scale[:, None, None] * la2).contiguous()
    w0 = torch.from_numpy(2.0 * rng.standard_normal(
        (lanes, lt.nodes_pad, n))).float().cuda()
    u0 = torch.from_numpy(rng.uniform(-1.0, 1.0, (lanes, lt.edges_pad, n))
                          ).float().cuda() * la
    major = backends._fused_stores(lt, w0, u0, dtype)
    minor = backends._fused_stores(lt, w0, u0, dtype, lane_minor=True)
    rest = (lt.pad_node_store(lt.inc_edges), lt.pad_node_store(lt.inc_signs),
            params_s, tau_s, src2, dst2, sig2)
    kw = dict(loss=problem.loss, reg=problem.regularizer, pkeys=pkeys,
              block_nodes=lt.block_nodes, block_edges=lt.block_edges,
              kn=lt.kn, klo=lt.klo, khi=lt.khi, rho=1.9, iters=iters,
              compute_residual=True, incidence=lt.compact)
    return [*major, *rest, la], [*minor, *rest, _lane_minor(la)], kw


def _kernel(args, kw, **more):
    return fused_pd_step(*args[:2], *args[4:], **kw, **more)


def _plain(args, kw):
    return fused_pd_step_ref(*args, **{k: v for k, v in kw.items()
                                       if k != "incidence"})


def _one_lane(args, lane):
    out = list(args)
    for i in (0, 1, 9):
        out[i] = args[i][lane].contiguous()
    return out


def _near_plain(got, want, dtype, iters):
    g = [t.float().cpu().numpy() for t in got[:2]]
    w = [t.float().cpu().numpy() for t in want[:2]]
    for a, b in zip(g, w):
        if dtype == torch.float32:
            tol = STEP_TOL if iters == 1 else SOLVE_TOL
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
        else:
            assert np.abs(a - b).max() <= _bf16_ulp(float(np.abs(b).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("loss", sorted(SCENARIOS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("iters", [1, 5])
@pytest.mark.parametrize("lanes", LANES)
def test_cuda_lane_minor_launch(loss, dtype, iters, lanes):
    """A lane-minor launch, aligned and one element off, at each labeled
    share: each lane the bits of its one-lane launch and of the
    lane-major launch's lane, and the launch near the plain version."""
    _need_card()
    dt = getattr(torch, dtype)
    for share in SHARES:
        problem = _problem(loss, share, seed=lanes)
        major, minor, kw = _launch_inputs(problem, lanes, dt, iters)
        want = _plain(major, kw)
        got_major = _kernel(major, kw)
        ones = [_kernel(_one_lane(major, k), kw) for k in range(lanes)]
        for shift in (False, True):
            args = list(minor)
            if shift:
                for i in (0, 1, 9):
                    args[i] = _shifted(args[i])
            before = args[0].clone()
            got = _kernel(args, kw)
            torch.cuda.synchronize()
            case = (loss, dtype, iters, lanes, share, shift)
            for k, one in enumerate(ones):
                for g, o in zip(got, one):
                    assert torch.equal(g[k], o), case
            for g, m in zip(got, got_major):
                assert torch.equal(g, m), case
            _near_plain(got, want, dt, iters)
            assert torch.equal(args[0], before), case   # inputs untouched


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_lane_minor_in_place(dtype):
    """Six lanes updated in place on lane-minor stores (``out`` the owned
    rows, as the solver launches it): the bits of the launch into fresh
    outputs."""
    _need_card()
    dt = getattr(torch, dtype)
    _, minor, kw = _launch_inputs(_problem("squared", 0.1), 6, dt, 1)
    want = _kernel(minor, kw)
    w_store, u_store = minor[0].clone(), minor[1].clone()
    nodes, edges = want[0].shape[1], want[1].shape[1]
    lo = kw["klo"] * kw["block_edges"]
    got = _kernel([w_store, u_store, *minor[2:]], kw,
                  out=(w_store[:, :nodes], u_store[:, lo:lo + edges]))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(w_store[:, :nodes], want[0])


@pytest.mark.cuda
def test_cuda_lane_minor_refused_past_the_lane_kernel():
    """Lane-minor state sent to the wide variant (n = 17) or to the
    streamed logistic variant is refused, naming the variant; one lane
    of lane-minor storage too (the one-lane kernel reads rows n apart)."""
    _need_card()
    _, minor, kw = _launch_inputs(_problem("squared", 0.1, n=17), 3,
                                  torch.float32, 1)
    with pytest.raises(ValueError, match="squared/float32/wide"):
        _kernel(minor, kw)
    _, minor, kw = _launch_inputs(_problem("logistic", 0.1), 3,
                                  torch.float32, 1)
    with pytest.raises(ValueError, match="logistic/float32/streamed"):
        _kernel(minor, kw, streamed=True)
    one = [minor[0][:1], minor[1][:1], *minor[2:9], minor[9][:1]]
    with pytest.raises(ValueError, match="over 1 lane"):
        _kernel(one, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", sorted(SCENARIOS))
def test_cuda_fused_path_runs_lane_minor(loss, monkeypatch):
    """``solve_path`` through the fused lanes on the card: its lane
    launches run on lane-minor stores, and the path is the one on
    lane-major stores, bit for bit."""
    _need_card()
    problem = get_scenario(SCENARIOS[loss]).build(seed=0, smoke=True,
                                                  device="cuda").problem
    cfg = SolverConfig(backend="pallas", fused=True, rho=1.9, warm_iters=20,
                       final_iters=20, metric_every=10)
    lams = (1e-3, 3e-3, 1e-2, 3e-2)
    before = sum(fused_pd_step.lane_minor_launches.values())
    got = solve_path(problem, lams, cfg)
    assert sum(fused_pd_step.lane_minor_launches.values()) == before + 2
    monkeypatch.setattr(backends, "_fused_lane_minor", lambda *a: False)
    want = solve_path(problem, lams, cfg)
    assert sum(fused_pd_step.lane_minor_launches.values()) == before + 2
    for name in ("w", "u", "objective"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
