"""Public surface of the port's networked federated learning core
(counterpart of ``repro.core``).

The paper's system — empirical graphs of local datasets, the network
Lasso objective (eq. 4), and Algorithm 1 — behind one declarative API:

    from repro_torch.core import Problem, Solver, SolverConfig

    problem = Problem.create(graph, data, lam=1e-3, loss="squared")
    result = Solver(SolverConfig(num_iters=1000, rho=1.9)).run(problem)

Losses (§4.1-4.3), regularizers (TV / GTVMin), and execution backends
(dense / sharded / pallas / federated) are pluggable registries; the
legacy convenience front-ends remain available as thin adapters in
``repro_torch.core.nlasso``.  Besides these, the package holds the
planners, the mesh and the sharded solvers of the port
(``partition``, ``mesh``, ``distributed``), FedTV (``fedtv``) and the
Table-1 baselines (``baselines``).

Implementation note: the ``repro_torch.api`` package itself imports the
leaf modules here (graph, losses), so everything that would close that
cycle is re-exported lazily (PEP 562) — only the leaf modules load
eagerly.
"""
import importlib

from repro_torch.core.graph import (EmpiricalGraph, barabasi_albert_graph,
                                    build_graph, chain_graph,
                                    graph_signal_mse, grid_graph, sbm_graph,
                                    watts_strogatz_graph)
from repro_torch.core.losses import NodeData

# name -> defining module, resolved on first attribute access
_LAZY = {name: "repro_torch.api" for name in (
    "BACKENDS", "LOSSES", "REGULARIZERS", "LassoLoss", "LogisticLoss",
    "Loss", "Problem", "Regularizer", "SolveResult", "Solver",
    "SolverConfig", "SquaredLoss", "SquaredTV", "TotalVariation",
    "certificate", "get_backend", "get_loss", "get_regularizer",
    "pd_iteration", "register_backend", "register_loss",
    "register_regularizer", "solve", "solve_path")}
# NOTE: the function `nlasso` is deliberately NOT re-exported here — the
# name would collide with the `repro_torch.core.nlasso` submodule (Python
# binds the submodule on `from repro_torch.core import nlasso`, shadowing
# any lazy attribute).  Use `from repro_torch.core.nlasso import nlasso`.
_LAZY.update({name: "repro_torch.core.nlasso" for name in (
    "NLassoResult", "nlasso_continuation",
    "primal_dual_gap_certificate")})

__all__ = sorted(set(_LAZY) | {
    "EmpiricalGraph", "NodeData", "barabasi_albert_graph", "build_graph",
    "chain_graph", "graph_signal_mse", "grid_graph", "sbm_graph",
    "watts_strogatz_graph"})


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
