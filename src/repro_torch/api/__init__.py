"""The port's Problem/Solver API (counterpart of ``repro.api``).

    from repro_torch.api import Problem, Solver, SolverConfig

    problem = Problem.create(graph, data, lam=1e-3, device="cuda")
    result = Solver(SolverConfig(backend="pallas", num_iters=1000,
                                 rho=1.9)).run(problem)
"""
from repro_torch.api.backends import (BACKENDS, certificate, get_backend,
                                      pd_iteration, register_backend)
from repro_torch.api.losses import (LOSSES, CallableLoss, LassoLoss,
                                    LogisticLoss, Loss, SquaredLoss,
                                    get_loss, register_loss)
from repro_torch.api.problem import Problem, SolveResult, SolverConfig
from repro_torch.api.regularizers import (REGULARIZERS, Regularizer,
                                          SquaredTV, TotalVariation,
                                          get_regularizer,
                                          register_regularizer)
from repro_torch.api.solver import Solver, solve, solve_many, solve_path

__all__ = [
    "BACKENDS", "CallableLoss", "LOSSES", "LassoLoss", "LogisticLoss",
    "Loss", "Problem", "REGULARIZERS", "Regularizer", "SolveResult",
    "Solver", "SolverConfig", "SquaredLoss", "SquaredTV", "TotalVariation",
    "certificate", "get_backend", "get_loss", "get_regularizer",
    "pd_iteration", "register_backend", "register_loss",
    "register_regularizer", "solve", "solve_many", "solve_path",
]
