"""The port's sharded backends over gloo worlds of 2 and 4 ranks on the CPU.

Each world runs once: this file, run as a script, is one rank (``python
tests/test_torch_sharded_ranks.py RANK WORLD DIR``), and the module's
fixture starts WORLD of them with a ``file://`` store under a temporary
directory, so that concurrent test workers never share a port.  Every
rank calls ``Solver.run`` with the whole problem
(``tests/test_distributed.py``'s fixture), as the reference's host does,
and writes what it got.  The checks are the reference's multi-device
ones (``tests/test_distributed.py:171-253``), against the reference's
dense solve:

  * ``sharded``, dense and boundary exchange, within 2e-4;
  * ``sharded_fused`` within 1e-4 and bit-identical on a rerun, with
    ``comm="auto"`` picking the reference's exchange (boundary at 2
    shards);
  * every rank returns the same ``w``;
  * a ``tol`` solve stops at the same chunk on every rank — the
    reference's stopping iteration.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

FIXTURE = dict(seed=3, cluster_sizes=(24, 24), p_in=0.5, p_out=5e-3,
               num_labeled=12)
ITERS = 150
LAM = 1e-3
# at lambda 1e-2 the block-max residual passes 1e-3 between iterations
# 600 and 650, well clear of the tolerance on both sides
TOL = dict(num_iters=2000, rho=1.9, metric_every=50, tol=1e-3)
TOL_LAM = 1e-2
WORLDS = (2, 4)
RUNS = ("sharded_dense", "sharded_boundary", "sharded_fused",
        "sharded_fused_rerun", "tol_sharded", "tol_sharded_fused")


def rank_main(rank: int, world: int, out: Path) -> None:
    """One rank: join the world, run every solve, write the results."""
    import torch.distributed as dist

    from repro_torch.api import Problem, Solver, SolverConfig
    from repro_torch.core.distributed import (shard_problem_fused,
                                              solve_nlasso_hier)
    from repro_torch.core.mesh import make_host_mesh
    from repro_torch.data.synthetic import make_sbm_regression

    torch.set_num_threads(1)          # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(world, 1, device="cpu")
        ds = make_sbm_regression(**FIXTURE, device="cpu")
        problem = Problem.create(ds.graph, ds.data, LAM, device="cpu")
        cfg = SolverConfig(num_iters=ITERS, mesh=mesh)
        w, its = {}, {}
        for comm in ("dense", "boundary"):
            w[f"sharded_{comm}"] = Solver(cfg.replace(
                backend="sharded", comm=comm)).run(problem).w
        hp = shard_problem_fused(ds.graph, ds.data, world, shard=rank)
        w["sharded_fused"], _, _, comm = solve_nlasso_hier(hp, mesh, LAM,
                                                           ITERS)
        w["sharded_fused_rerun"] = Solver(cfg.replace(
            backend="sharded_fused")).run(problem).w
        for backend in ("sharded", "sharded_fused"):
            res = Solver(SolverConfig(**TOL, backend=backend,
                                      mesh=mesh)).run(
                problem.with_lam(TOL_LAM))
            w[f"tol_{backend}"] = res.w
            its[backend] = int(res.diagnostics["iterations"])
        np.savez(out / f"rank{rank}.npz",
                 **{k: v.numpy() for k, v in w.items()})
        (out / f"rank{rank}.json").write_text(json.dumps(
            {"comm": comm, "iterations": its,
             "transport": mesh.transport, "via_host": mesh.via_host}))
    finally:
        dist.destroy_process_group()


_worlds: dict = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(S)``: each rank's (arrays, record) from one world of S
    ranks, started once per S."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))

    def get(size: int):
        if size not in _worlds:
            out = tmp_path_factory.mktemp(f"world{size}")
            procs = [subprocess.Popen(
                [sys.executable, __file__, str(r), str(size), str(out)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True) for r in range(size)]
            try:
                errs = [p.communicate(timeout=240)[1] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for r, (p, err) in enumerate(zip(procs, errs)):
                assert p.returncode == 0, (r, err[-3000:])
            _worlds[size] = [
                (dict(np.load(out / f"rank{r}.npz")),
                 json.loads((out / f"rank{r}.json").read_text()))
                for r in range(size)]
        return _worlds[size]

    return get


@pytest.fixture(scope="module")
def reference():
    """The reference's dense solves: (w at LAM after ITERS, the tol
    solve at TOL_LAM) and the reference's hierarchy cut fraction per
    world size."""
    from repro.api import Problem, Solver, SolverConfig
    from repro.core.distributed import resolve_comm
    from repro.core.partition import cluster_partition, plan_hierarchy
    from repro.data.synthetic import make_sbm_regression

    ds = make_sbm_regression(**FIXTURE)
    w = np.asarray(Solver(SolverConfig(num_iters=ITERS)).run(
        Problem.create(ds.graph, ds.data, LAM)).w)
    tol = Solver(SolverConfig(**TOL)).run(
        Problem.create(ds.graph, ds.data, TOL_LAM))
    comms = {s: resolve_comm("auto", plan_hierarchy(
        ds.graph, cluster_partition(ds.graph, s), s).cut_fraction)
        for s in WORLDS}
    return {"w": w, "tol_w": np.asarray(tol.w),
            "tol_iterations": int(tol.diagnostics["iterations"]),
            "comm": comms}


def max_diff(a, b) -> float:
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("size", WORLDS)
@pytest.mark.parametrize("run,bound", [("sharded_dense", 2e-4),
                                       ("sharded_boundary", 2e-4),
                                       ("sharded_fused", 1e-4),
                                       ("sharded_fused_rerun", 1e-4)])
def test_rank_solves_match_reference_dense(world, reference, size, run,
                                           bound):
    for r, (arrays, _) in enumerate(world(size)):
        assert max_diff(arrays[run], reference["w"]) <= bound, (size, r, run)


@pytest.mark.parametrize("size", WORLDS)
def test_sharded_fused_rerun_is_bitwise(world, size):
    for arrays, _ in world(size):
        np.testing.assert_array_equal(arrays["sharded_fused_rerun"],
                                      arrays["sharded_fused"])


@pytest.mark.parametrize("size", WORLDS)
def test_every_rank_returns_the_same_w(world, size):
    ranks = world(size)
    for arrays, _ in ranks[1:]:
        for run in RUNS:
            np.testing.assert_array_equal(arrays[run], ranks[0][0][run],
                                          err_msg=run)


@pytest.mark.parametrize("size", WORLDS)
def test_auto_comm_picks_the_reference_exchange(world, reference, size):
    assert all(rec["comm"] == reference["comm"][size]
               for _, rec in world(size))
    if size == 2:
        # the fixture's cut is small at two shards
        assert reference["comm"][size] == "boundary"
    assert all(rec["transport"] == "gloo" and not rec["via_host"]
               for _, rec in world(size))


@pytest.mark.parametrize("backend", ["sharded", "sharded_fused"])
@pytest.mark.parametrize("size", WORLDS)
def test_tol_solve_stops_at_the_same_chunk_on_every_rank(world, reference,
                                                         size, backend):
    ranks = world(size)
    stops = {rec["iterations"][backend] for _, rec in ranks}
    assert stops == {reference["tol_iterations"]}, stops
    for arrays, _ in ranks:
        assert max_diff(arrays[f"tol_{backend}"],
                        reference["tol_w"]) <= 1e-4


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
