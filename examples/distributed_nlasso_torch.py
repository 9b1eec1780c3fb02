"""Distributed nLasso (PyTorch port): Algorithm 1 as message passing over
a world of ranks, with cluster-aware graph partitioning and boundary-only
halo exchange — all through the port's Problem/Solver API (the "sharded"
backend).

The reference fakes 8 devices in one process; the port runs one process
a rank instead: this script starts its own gloo world of ``--ranks``
processes (default 8), joined through a ``file://`` store in a temporary
directory.  Every rank runs ``Solver.run`` on the whole problem (SPMD:
each keeps its own shard and gets the same result); rank 0 prints.

    python examples/distributed_nlasso_torch.py                 # CUDA card
    python examples/distributed_nlasso_torch.py --device cpu --ranks 2
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch                                                   # noqa: E402
import torch.distributed as dist                               # noqa: E402
import torch.multiprocessing as mp                             # noqa: E402

from repro_torch.core import Problem, Solver, SolverConfig     # noqa: E402
from repro_torch.core.distributed import shard_problem         # noqa: E402
from repro_torch.core.mesh import make_host_mesh               # noqa: E402
from repro_torch.data.synthetic import make_sbm_regression     # noqa: E402
from repro_torch.device import resolve_device                  # noqa: E402


def run(rank: int, ranks: int, device) -> None:
    """The demo on one rank of an initialized world of ``ranks``."""
    say = print if rank == 0 else (lambda *a, **k: None)
    ds = make_sbm_regression(seed=0, cluster_sizes=(150, 150), p_in=0.5,
                             p_out=1e-3, num_labeled=30, device=device)
    mesh = make_host_mesh(ranks, 1, device=device)
    problem = Problem.create(ds.graph, ds.data, lam=1e-3, device=device)
    say(f"mesh: {dict(mesh.shape)}  graph: |V|={ds.graph.num_nodes} "
        f"|E|={ds.graph.num_edges}", flush=True)

    for partitioner in ("block", "cluster"):
        # partition statistics (the layout the sharded backend will build)
        prob = shard_problem(ds.graph, ds.data, ranks,
                             partitioner=partitioner, shard=rank)
        say(f"\npartitioner={partitioner}: cut edges {prob.plan.cut_edges} "
            f"/ {ds.graph.num_edges}, boundary nodes "
            f"{prob.plan.boundary_nodes} / {ds.graph.num_nodes}")
        for comm in ("dense", "boundary"):
            cfg = SolverConfig(backend="sharded", mesh=mesh, num_iters=500,
                               rho=1.9, partitioner=partitioner, comm=comm)
            t0 = time.time()
            res = Solver(cfg).run(problem)
            dt = time.time() - t0
            err = float(torch.mean((res.w - ds.w_true) ** 2))
            say(f"  comm={comm:9s} 500 iters in {dt:5.1f}s   "
                f"weight MSE vs truth {err:.3e}", flush=True)

    # same Problem, same Solver surface — only the backend string changes
    ref = Solver(SolverConfig(backend="dense", num_iters=500, rho=1.9)
                 ).run(problem)
    shd = Solver(SolverConfig(backend="sharded", mesh=mesh, num_iters=500,
                              rho=1.9, comm="dense")).run(problem)
    gap = float((shd.w - ref.w).abs().max())
    say(f"\nmax |sharded - dense| after 500 iters: {gap:.2e} "
        "(identical fixed-point iteration, different communication "
        "pattern)", flush=True)


def rank_main(rank: int, ranks: int, store: str, device) -> None:
    """One process of the world: join it, run the demo, leave it."""
    torch.set_num_threads(1)          # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=ranks)
    try:
        run(rank, ranks, device)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8,
                    help="processes in the gloo world (default 8)")
    ap.add_argument("--device", default=None,
                    help="torch device of every rank (default: the CUDA "
                         "card, shared by the ranks)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)   # no card: raise before spawning
    with tempfile.TemporaryDirectory(prefix="nlasso_world_") as tmp:
        mp.spawn(rank_main, args=(args.ranks, os.path.join(tmp, "store"),
                                  device), nprocs=args.ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
