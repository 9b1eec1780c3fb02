"""Quickstart (PyTorch port): federated networked linear regression on
the paper's setup.

Builds the §5 stochastic-block-model empirical graph, declares the network
Lasso as a `Problem`, runs Algorithm 1 through the port's `Solver`, and
compares against the pooled baselines — the 60-second tour of the whole
public API of `repro_torch`.

    python examples/quickstart_torch.py                # full §5 setup, CUDA card
    python examples/quickstart_torch.py --device cpu   # on the CPU
    REPRO_SMOKE=1 python examples/quickstart_torch.py  # CI-sized instance
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np                                             # noqa: E402

from repro_torch.core import (Problem, Solver, SolverConfig,   # noqa: E402
                              baselines)
from repro_torch.data.synthetic import make_sbm_regression     # noqa: E402
from repro_torch.device import to_host                         # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    smoke = bool(os.environ.get("REPRO_SMOKE"))

    # 1. networked data: 300 local datasets, 2 clusters, 30 labeled nodes
    sizes, labeled = ((40, 40), 16) if smoke else ((150, 150), 30)
    ds = make_sbm_regression(seed=0, cluster_sizes=sizes, p_in=0.5,
                             p_out=1e-3, num_labeled=labeled,
                             device=args.device)
    print(f"empirical graph: |V|={ds.graph.num_nodes} "
          f"|E|={ds.graph.num_edges} labeled={len(ds.labeled_nodes)}")

    # 2. declare the problem (graph + data + pluggable loss/regularizer) ...
    problem = Problem.create(ds.graph, ds.data, lam=1e-3, loss="squared",
                             regularizer="tv", device=args.device)

    # 3. ... and solve it (Algorithm 1 + lambda continuation, over-relaxed)
    config = SolverConfig(continuation=True, rho=1.9,
                          warm_iters=600 if smoke else 3000,
                          final_iters=300 if smoke else 1000)
    res = Solver(config).run(problem, w_true=ds.w_true)
    print(f"weight-vector MSE (paper eq. 24): {float(res.mse[-1]):.2e}")
    print("optimality certificate:",
          {k: f"{float(v):.2e}" for k, v in res.diagnostics.items()})

    # 4. the learned weights recover the per-cluster ground truth
    w = to_host(res.w)
    for c, truth in ((0, (2.0, 2.0)), (1, (-2.0, 2.0))):
        mean = w[ds.clusters == c].mean(axis=0)
        print(f"cluster {c}: learned mean w = ({mean[0]:+.3f}, "
              f"{mean[1]:+.3f})   truth = ({truth[0]:+.1f}, {truth[1]:+.1f})")

    # 5. baselines that ignore the network structure (paper Table 1)
    pred = np.einsum("vmn,vn->vm", to_host(ds.data.x), w)
    lm = to_host(ds.data.labeled_mask) > 0
    ours = float(np.mean((pred[~lm] - to_host(ds.data.y)[~lm]) ** 2))
    w_pool = baselines.pooled_linear_regression(ds.data)
    print(f"test MSE — nLasso: {ours:.2e}   pooled linear regression: "
          f"{baselines.linreg_mse(ds.data, w_pool, 'test'):.2f}   "
          f"decision tree: {baselines.decision_tree_mse(ds.data, 'test'):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
