"""The Solver front-end: backend dispatch and continuation.

    problem = Problem.create(graph, data, lam=1e-3, loss="squared")
    result = Solver(SolverConfig(num_iters=1000, rho=1.9)).run(problem)

``Solver.run`` dispatches through the backend registry and optionally
wraps the run in the lambda-continuation schedule.
``REPRO_SOLVER_MAX_ITERS`` (env) caps every phase's iteration count.
The reference's ``solve_path`` and ``solve_many`` are not in this slice.
"""
from __future__ import annotations

import dataclasses

from repro_torch.api.backends import get_backend
from repro_torch.api.problem import Problem, SolveResult, SolverConfig
from repro_torch.engine import capped as _capped
from repro_torch.engine import default_warm_lam as _default_warm_lam


@dataclasses.dataclass(frozen=True)
class Solver:
    """Backend-dispatching runner for :class:`Problem` instances."""

    config: SolverConfig = SolverConfig()

    def run(self, problem: Problem, *, w0=None, u0=None,
            w_true=None) -> SolveResult:
        """Solve ``problem`` per the config on the problem's device."""
        cfg = self.config
        backend = get_backend(cfg.backend)
        if w_true is not None:
            w_true = w_true.to(problem.device)
        if not cfg.continuation:
            run_cfg = cfg.replace(
                num_iters=_capped(cfg.num_iters, cfg.metric_every))
            return backend(problem, run_cfg, w0=w0, u0=u0, w_true=w_true)

        warm_lam = (cfg.warm_lam if cfg.warm_lam is not None
                    else _default_warm_lam(float(problem.lam)))
        warm_cfg = cfg.replace(
            continuation=False, compute_diagnostics=False,
            record_residual=False,
            num_iters=_capped(cfg.warm_iters, cfg.metric_every))
        warm = backend(problem.with_lam(warm_lam), warm_cfg, w0=w0, u0=u0)
        # re-project the warm duals onto the target feasible set
        u_warm = problem.regularizer.project_dual(
            warm.u, problem.graph, problem.lam)
        final_cfg = cfg.replace(
            continuation=False,
            num_iters=_capped(cfg.final_iters, cfg.metric_every))
        return backend(problem, final_cfg, w0=warm.w, u0=u_warm,
                       w_true=w_true)


def solve_path(*args, **kwargs):
    """λ-path sweeps are not ported yet (ROADMAP.md Open items §1 item 8)."""
    raise NotImplementedError(
        "solve_path is not ported yet: ROADMAP.md Open items §1 item 8")


def solve_many(*args, **kwargs):
    """Batched solves are not ported yet (ROADMAP.md Open items §1 item 8)."""
    raise NotImplementedError(
        "solve_many is not ported yet: ROADMAP.md Open items §1 item 8")
