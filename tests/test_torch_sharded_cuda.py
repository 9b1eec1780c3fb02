"""The sharded backends on the card (``-m cuda``; they skip without one).

On a one-rank mesh on the GPU, against the dense backend on the card:

  * ``sharded_fused`` on every scenario launches ``fused_pd_step`` once
    an iteration, counted by the kernel itself, and lands within 1e-4 of
    the dense solve; ``sharded`` (plain ops, dense and boundary exchange)
    launches it never and lands there too;
  * one step of the kernel on each shard's layout of a 4-shard
    hierarchy (padding rows, replicated slots, the across-shard extents)
    is within 1e-5 of the plain version on the same inputs;
  * a loss the kernel cannot take (a logistic node past n = 336) is
    refused by ``sharded_fused`` on the card, where the plain step never
    runs.

This file imports nothing of the reference, so it runs on a machine
without JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Problem, Solver, SolverConfig      # noqa: E402
from repro_torch.api.regularizers import TotalVariation        # noqa: E402
from repro_torch.core.distributed import shard_problem_fused   # noqa: E402
from repro_torch.core.losses import NodeData                   # noqa: E402
from repro_torch.core.mesh import make_host_mesh               # noqa: E402
from repro_torch.data.synthetic import make_sbm_regression     # noqa: E402
from repro_torch.kernels import _build, ops                    # noqa: E402
from repro_torch.kernels.ref import fused_pd_step_ref          # noqa: E402
from repro_torch.scenarios import SCENARIOS, get_scenario      # noqa: E402

CONF = dict(num_iters=200, rho=1.9)
FIXTURE = dict(seed=3, cluster_sizes=(24, 24), p_in=0.5, p_out=5e-3,
               num_labeled=12)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _runs(fn) -> int:
    """``fused_pd_step``'s runs on the card while ``fn()`` runs, counted
    by the kernel."""
    torch.cuda.synchronize()
    _build.reset_executions()
    fn()
    torch.cuda.synchronize()
    return _build.executions("fused_pd_step")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cuda_sharded_backends_match_dense(name):
    _need_card()
    problem = get_scenario(name).build(seed=0, smoke=True,
                                       device="cuda").problem
    dense = Solver(SolverConfig(**CONF)).run(problem)
    mesh = make_host_mesh(1, 1)
    for kw, runs in ((dict(backend="sharded_fused"), CONF["num_iters"]),
                     (dict(backend="sharded", comm="dense"), 0),
                     (dict(backend="sharded", comm="boundary"), 0)):
        out = {}

        def solve():
            out["res"] = Solver(SolverConfig(**CONF, **kw, mesh=mesh)).run(
                problem)
        assert _runs(solve) == runs, kw
        res = out["res"]
        assert res.w.device.type == "cuda"
        diff = float((res.w - dense.w).abs().max())
        assert diff <= 1e-4, (name, kw, diff)
        np.testing.assert_allclose(float(res.objective[-1]),
                                   float(dense.objective[-1]), rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shard", range(4))
def test_cuda_kernel_matches_plain_version_on_shard_layouts(shard):
    _need_card()
    ds = make_sbm_regression(**FIXTURE, device="cuda")
    hp = shard_problem_fused(ds.graph, ds.data, 4, shard=shard)
    h = hp.hier
    nv, ne, lo = h.nodes_pad, h.edges_pad, h.klo * h.block_edges
    gen = torch.Generator(device="cuda").manual_seed(shard)
    la = 1e-2 * hp.bound_unit
    w_store = torch.zeros((h.w_store_rows, 2), device="cuda")
    w_store[:nv] = torch.randn((nv, 2), generator=gen, device="cuda")
    u_store = torch.zeros((h.u_store_rows, 2), device="cuda")
    u_store[lo:lo + ne] = la * (2 * torch.rand((ne, 2), generator=gen,
                                               device="cuda") - 1)
    pkeys = tuple(sorted(hp.prox_params))
    args = (w_store, u_store, hp.inc_edges, hp.inc_signs,
            tuple(hp.prox_params[k].contiguous() for k in pkeys), hp.tau,
            hp.src, hp.dst, torch.full((ne, 1), 0.5, device="cuda"), la)
    kw = dict(loss=hp.loss, reg=TotalVariation(), pkeys=pkeys,
              block_nodes=h.block_nodes, block_edges=h.block_edges,
              kn=h.kn, klo=h.klo, khi=h.khi, rho=1.9)
    got = ops.pd_step(*args, **kw, incidence=hp.incidence)
    want = fused_pd_step_ref(*args, **kw)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_sharded_fused_refuses_what_the_kernel_cannot_take():
    _need_card()
    ds = make_sbm_regression(**FIXTURE, device="cuda")
    v, n, m = ds.graph.num_nodes, 337, 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = NodeData(
        x=torch.randn((v, m, n), generator=gen, device="cuda"),
        y=(torch.rand((v, m), generator=gen, device="cuda") < 0.5).float(),
        sample_mask=torch.ones((v, m), device="cuda"),
        labeled_mask=ds.data.labeled_mask)
    problem = Problem.create(ds.graph, data, 1e-2, loss="logistic",
                             device="cuda")
    with pytest.raises(NotImplementedError, match="fused_pd_step"):
        Solver(SolverConfig(num_iters=5, backend="sharded_fused")).run(
            problem)
