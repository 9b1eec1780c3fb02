"""The plain reference against the port's dense backend on the CPU, at a
tiny size: the same iterates over a fixed budget, for each loss, and
over lambda lanes."""
import _tiny
import numpy as np
import pytest
import torch

from perfbench import data, topology
from perfbench.ref.alg1 import Alg1, max_gap


def instance(loss: str, seed: int = 3):
    cell = _tiny.tiny_cell("squared.solve_tol" if loss == "squared"
                           else "logistic.solve_tol", nodes=600)
    cfg = cell.config
    src, dst, assign = topology.draw_edges(cfg["graph"])
    ds = data.make_pool(cfg, torch.from_numpy(assign), seed, 1)[0]
    return cfg, src, dst, ds


def port_problem(cfg, src, dst, ds, lam):
    from repro_torch.api import Problem
    from repro_torch.core.graph import build_graph
    from repro_torch.core.losses import NodeData
    g = build_graph(np.stack([src, dst], 1), np.ones(src.shape, np.float32),
                    cfg["graph"]["nodes"], device="cpu")
    nd = NodeData(x=ds.x, y=ds.y, sample_mask=torch.ones(ds.y.shape),
                  labeled_mask=ds.labeled.to(torch.float32))
    return Problem.create(g, nd, lam, loss=cfg["loss"], device="cpu",
                          **cfg.get("loss_kwargs", {}))


@pytest.mark.parametrize("loss", ["squared", "logistic"])
def test_reference_matches_dense(loss):
    from repro_torch.api import Solver, SolverConfig
    cfg, src, dst, ds = instance(loss)
    prob = port_problem(cfg, src, dst, ds, cfg["lam"])
    got = Solver(SolverConfig(num_iters=300, rho=cfg["rho"],
                              metric_every=300)).run(prob).w
    ref = Alg1(torch.from_numpy(src), torch.from_numpy(dst),
               torch.ones(src.shape), ds.x, ds.y, ds.labeled, loss=loss,
               lams=cfg["lam"], rho=cfg["rho"])
    w, u = ref.zeros(2)
    w, u, res = ref.block(w, u, 300)
    assert max_gap(got, w) < 1e-4
    assert float(res) > 0


def test_reference_lanes_match_one_lane_solves():
    cfg, src, dst, ds = instance("squared")
    lams = [0.1, 0.01, 0.001]
    args = (torch.from_numpy(src), torch.from_numpy(dst),
            torch.ones(src.shape), ds.x, ds.y, ds.labeled)
    lanes = Alg1(*args, loss="squared", lams=lams, rho=1.9)
    w, u = lanes.zeros(2)
    w, u, res = lanes.block(w, u, 50)
    assert res.shape == (3,)
    for i, lam in enumerate(lams):
        one = Alg1(*args, loss="squared", lams=lam, rho=1.9)
        w1, u1 = one.zeros(2)
        w1, u1, r1 = one.block(w1, u1, 50)
        assert max_gap(w[i], w1) < 1e-12
        assert float(r1) == pytest.approx(float(res[i]), rel=1e-12)


def test_tol_stop_matches_the_port():
    """The reference's stop (first block with residual <= tol) is the
    port's fused tol solve's on the same instance."""
    from repro_torch.api import Solver, SolverConfig
    from perfbench.ref.alg1 import solve_to_stop
    cfg, src, dst, ds = instance("squared")
    prob = port_problem(cfg, src, dst, ds, cfg["lam"])
    r = Solver(SolverConfig(backend="pallas", fused=True, num_iters=2000,
                            rho=cfg["rho"], metric_every=10,
                            tol=cfg["tol"])).run(prob)
    k = int(r.diagnostics["iterations"])
    ref = Alg1(torch.from_numpy(src), torch.from_numpy(dst),
               torch.ones(src.shape), ds.x, ds.y, ds.labeled,
               loss="squared", lams=cfg["lam"], rho=cfg["rho"])
    w, _, stop, ok = solve_to_stop(ref, *ref.zeros(2), program_iters=k,
                                   tol=cfg["tol"], metric_every=10,
                                   budget=2000)
    assert ok and stop == k < 2000
    assert max_gap(r.w, w) < 1e-4
