"""Network Lasso primal-dual solver (paper Algorithm 1) — legacy surface.

Solves   min_w  sum_{i in M} L(X^(i), w^(i)) + lambda ||w||_TV        (eq. 4)
jointly with its dual (eq. 7) by the diagonally-preconditioned primal-dual
iterations (eqs. 14-15) with preconditioners sigma_e = 1/2, tau_i = 1/|N_i|
(eq. 13).

The iteration itself lives in the port's API (``repro_torch.api``): a
:class:`~repro_torch.api.problem.Problem` solved by
:class:`~repro_torch.api.solver.Solver` through a backend registry.
Everything in this module is a thin adapter with the reference's
signatures (``repro.core.nlasso``):

  * :func:`nlasso` / :func:`nlasso_continuation` — convenience front-ends,
  * :func:`solve_nlasso` — the old tuple-returning engine entry point
    (deprecated; accepts caller-built prox/clip callables),
  * :func:`pd_step` — one primal-dual iteration (delegates to
    ``api.pd_iteration``),
  * :func:`primal_dual_gap_certificate` — eq. 11 diagnostics (delegates to
    ``api.certificate``).

Each solves on the device of the graph it is given (which the graph's
constructor puts on the CUDA card unless the caller names another).  The
kernel hooks ``affine_fn`` / ``clip_fn`` take the port's kernels
(``kernels.ops.batched_affine`` / ``kernels.ops.tv_prox``), which launch
their CUDA kernel on the card.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple

import torch

from repro_torch.api.backends import _solve_dense, certificate, pd_iteration
from repro_torch.api.losses import CallableLoss, get_loss
from repro_torch.api.problem import Problem, SolverConfig
from repro_torch.api.regularizers import TotalVariation
from repro_torch.api.solver import Solver
from repro_torch.core import losses as L
from repro_torch.core.graph import EmpiricalGraph

_TV = TotalVariation()


class SolverState(NamedTuple):
    w: torch.Tensor   # (V, n) primal graph signal
    u: torch.Tensor   # (E, n) dual edge signal


@dataclasses.dataclass(frozen=True)
class NLassoResult:
    w: torch.Tensor              # final primal weights (V, n)
    u: torch.Tensor              # final dual variables (E, n)
    objective: torch.Tensor      # (iters,) primal objective trace
    mse: torch.Tensor | None     # (iters,) MSE vs. true weights, if provided


def pd_step(graph: EmpiricalGraph, prox: Callable, lam: float,
            tau: torch.Tensor, sigma: torch.Tensor, state: SolverState,
            clip_fn: Callable | None = None) -> SolverState:
    """One primal-dual iteration (Algorithm 1 body) — adapter over
    ``api.pd_iteration`` with the TV regularizer."""
    w, u = pd_iteration(graph, prox, _TV, lam, tau, sigma, state.w, state.u,
                        clip_fn=clip_fn)
    return SolverState(w, u)


def _legacy_problem(graph, data, lam, loss, alpha, num_inner):
    """Map the old string-dispatch arguments onto a Problem on the
    graph's device.

    The legacy front-ends accepted ``alpha``/``num_inner`` regardless of
    the loss; ``core.losses._resolve`` drops whatever the named loss
    doesn't take.
    """
    return Problem.create(graph, data, lam,
                          loss=L._resolve(loss, alpha, num_inner),
                          device=graph.device)


def solve_nlasso(graph: EmpiricalGraph, data: L.NodeData, prox: Callable,
                 lam: float, num_iters: int, *, loss: str = "squared",
                 w0: torch.Tensor | None = None,
                 u0: torch.Tensor | None = None,
                 w_true: torch.Tensor | None = None,
                 clip_fn: Callable | None = None,
                 rho: float = 1.0):
    """Deprecated: run Algorithm 1 with a caller-built ``prox``.

    Returns the old ``(w, u, objective_trace, mse_trace)`` tuple (a zero
    MSE trace without ``w_true``).  Prefer
    ``Solver(SolverConfig(...)).run(Problem.create(...))`` — the prox is
    then built from the loss registry and kernels are wired per backend.

    Note the objective trace prices the local loss with the *base* loss
    (alpha = 0 for "lasso"), matching the historical behaviour.

    The warm start ``w0``/``u0`` is read, never written: the solve starts
    from it as float32 on the graph's device (a tensor already so is used
    as it is, not copied) and returns new tensors, so the caller may
    reuse it afterwards.
    """
    warnings.warn(
        "solve_nlasso is deprecated; use repro_torch.api.Solver.run "
        "(Problem.create + SolverConfig)", DeprecationWarning, stacklevel=2)
    problem = Problem(graph=graph, data=data, lam=float(lam),
                      loss=CallableLoss(prox_fn=prox, base=get_loss(loss)))
    res = _solve_dense(problem, SolverConfig(num_iters=num_iters, rho=rho),
                       w0=w0, u0=u0, w_true=w_true, clip_fn=clip_fn)
    mse = res.mse if res.mse is not None else torch.zeros_like(res.objective)
    return res.w, res.u, res.objective, mse


def nlasso(graph: EmpiricalGraph, data: L.NodeData, lam: float,
           num_iters: int = 500, *, loss: str = "squared",
           alpha: float = 0.0, num_inner: int = 50,
           w_true: torch.Tensor | None = None,
           affine_fn: Callable | None = None,
           clip_fn: Callable | None = None,
           rho: float = 1.0) -> NLassoResult:
    """Convenience front-end: build the prox for ``loss`` and solve.

    loss in {"squared", "lasso", "logistic"} — paper §4.1 / §4.2 / §4.3.
    ``alpha`` is the local Lasso regularization weight (called lambda inside
    eq. 22; renamed to avoid clashing with the TV strength ``lam``).

    Thin adapter over the port's API; the caller-supplied
    ``affine_fn``/``clip_fn`` kernel hooks are forwarded through
    ``SolverConfig`` (the "pallas" backend wires the stock kernels without
    any hooks).

    As in the reference, for ``loss="lasso"`` the objective trace
    includes the local ``alpha * ||w||_1`` term.
    """
    problem = _legacy_problem(graph, data, lam, loss, alpha, num_inner)
    res = Solver(SolverConfig(num_iters=num_iters, rho=rho,
                              clip_fn=clip_fn, affine_fn=affine_fn)).run(
        problem, w_true=w_true)
    return NLassoResult(w=res.w, u=res.u, objective=res.objective,
                        mse=res.mse)


def nlasso_continuation(graph: EmpiricalGraph, data: L.NodeData,
                        lam: float, *, loss: str = "squared",
                        alpha: float = 0.0, num_inner: int = 50,
                        warm_lam: float | None = None,
                        warm_iters: int = 3000, final_iters: int = 1000,
                        rho: float = 1.9,
                        w_true: torch.Tensor | None = None,
                        affine_fn: Callable | None = None,
                        clip_fn: Callable | None = None) -> NLassoResult:
    """Beyond-paper solver: lambda-continuation + over-relaxed PDHG.

    The dual clipping bound lambda*A_e limits how far an unlabeled node can
    move per iteration (|dw_i| <= tau_i * deg_i * lam * A_e = lam * A_e), so
    for small target lambda a cold start needs >= ||w*||/lam iterations just
    to *travel*.  We first solve at ``warm_lam`` (default 10x target, clipped
    to [1e-2, 1]) where propagation is fast, then re-clip the duals to the
    target bound and debias.

    Thin adapter over ``SolverConfig(continuation=True)``; caller-supplied
    kernel hooks are forwarded through the config.  As with :func:`nlasso`,
    the ``loss="lasso"`` objective trace includes the alpha term.
    """
    problem = _legacy_problem(graph, data, lam, loss, alpha, num_inner)
    cfg = SolverConfig(continuation=True, warm_lam=warm_lam,
                       warm_iters=warm_iters, final_iters=final_iters,
                       rho=rho, clip_fn=clip_fn, affine_fn=affine_fn)
    res = Solver(cfg).run(problem, w_true=w_true)
    return NLassoResult(w=res.w, u=res.u, objective=res.objective,
                        mse=res.mse)


def primal_dual_gap_certificate(graph: EmpiricalGraph, data: L.NodeData,
                                w: torch.Tensor, u: torch.Tensor,
                                lam: float) -> dict:
    """Optimality diagnostics from the coupled conditions (eq. 11).

    * dual feasibility: max |u_j^(e)| - lambda A_e  (must be <= 0)
    * stationarity residual for squared loss at labeled nodes:
        grad_i L + (D^T u)_i  (must be ~ 0)

    Adapter over ``api.certificate`` (on the card its pseudo-inverse is
    the ``sym_pinv`` kernel).
    """
    return certificate(Problem.create(graph, data, lam,
                                       device=graph.device), w, u)
