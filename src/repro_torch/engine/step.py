"""The canonical primal-dual iteration (paper Algorithm 1, eqs. 14-15).

The port's single statement of the iteration math, as
``repro.engine.step`` is the reference's.  One step is four primitives
over a :class:`GraphExecutor`:

    gather duals   dtu = D^T u            (executor.gather_duals)
    primal prox    w+  = PU(w - T dtu)    (loss prox, eq. 17)
    edge diff      dw  = D (2 w+ - w)     (executor.edge_diff)
    dual prox      u+  = prox_{sigma dg*}(u + Sigma dw)   (step 10)

plus the Krasnosel'skii-Mann relaxation folded in when ``rho != 1``.
The dense backend runs it through ``executors.DenseExecutor`` (and over
lanes, with one lambda per lane, ``executors.BatchedDenseExecutor``), the
fused kernel's plain version (``kernels.ref.fused_pd_step_ref``) through
``executors.WindowExecutor``, and the federated runtime through
``executors.MailboxExecutor``.
"""
from __future__ import annotations

import math
from typing import Callable, Protocol, runtime_checkable

import torch

from repro_torch.obs import profile as _prof
from repro_torch.obs.profile import annotate as _scope


def ensure_column(x):
    """(N,) -> (N, 1); scalars and already-columned tensors pass through.

    The engine's one shape convention: per-node/per-edge coefficient
    vectors broadcast against (N, n) signals as columns.
    """
    if isinstance(x, torch.Tensor) and x.ndim == 1:
        return x[:, None]
    return x


_col = ensure_column


@runtime_checkable
class GraphExecutor(Protocol):
    """How one backend realizes the two graph operators of Algorithm 1.

    ``weights`` carries the per-owned-edge A_e (executor edge order), so
    the executor can stand in for the graph inside the regularizer's
    dual resolvent.  ``owned_duals`` maps the dual state the gather
    reads to the dual rows this executor updates.
    """

    weights: torch.Tensor

    def gather_duals(self, u: torch.Tensor) -> torch.Tensor:
        """D^T u: (E', n) dual state -> (V', n) node aggregate."""
        ...

    def edge_diff(self, z: torch.Tensor) -> torch.Tensor:
        """D z: (V', n) node signal -> (E_owned, n) edge differences."""
        ...

    def owned_duals(self, u: torch.Tensor) -> torch.Tensor:
        """The (E_owned, n) rows of ``u`` this executor updates."""
        ...


def pd_step(executor: GraphExecutor, prox: Callable, regularizer, lam,
            tau: torch.Tensor, sigma: torch.Tensor, w: torch.Tensor,
            u: torch.Tensor, *, rho: float = 1.0,
            clip_fn: Callable | None = None,
            primal_update: Callable | None = None):
    """One primal-dual step — eqs. 14-15.

    primal (eq. 17):  w+ = PU(w - T D^T u)
    dual  (step 10):  u+ = prox_{sigma dg*}(u + Sigma D (2 w+ - w))
    KM relaxation:    x  <- x + rho (x+ - x)  (duals re-projected)

    ``primal_update(prox, w, dtu, tau)`` overrides the one-prox primal
    (the federated runtime plugs its local-update policy here);
    ``clip_fn`` routes the dual resolvent through a kernel; the
    relaxation's re-projection runs the plain clip, as in the reference.
    Each primitive runs in its paper-phase range
    (:mod:`repro_torch.obs.profile`, entered only while telemetry or a
    profiler is on).  Returns ``(w_new, u_new)`` with ``u_new`` over the
    executor's owned edges.
    """
    tau_c = _col(tau)
    sigma_c = _col(sigma)
    with _scope(_prof.PHASE_GATHER):
        dtu = executor.gather_duals(u)
    with _scope(_prof.PHASE_PRIMAL):
        if primal_update is None:
            w_new = prox(w - tau_c * dtu)
        else:
            w_new = primal_update(prox, w, dtu, tau)
    with _scope(_prof.PHASE_EDGE_DIFF):
        dw = executor.edge_diff(2.0 * w_new - w)
    with _scope(_prof.PHASE_DUAL):
        u_own = executor.owned_duals(u)
        u_new = regularizer.dual_prox(u_own + sigma_c * dw, executor, lam,
                                      sigma, clip_fn=clip_fn)
    if rho != 1.0:
        with _scope(_prof.PHASE_RELAX):
            w_new = w + rho * (w_new - w)
            u_new = regularizer.project_dual(
                u_own + rho * (u_new - u_own), executor, lam)
    return w_new, u_new


def pd_residual(tau, sigma, w, u, w_new, u_new, *,
                lanes: bool = False) -> torch.Tensor:
    """Scaled fixed-point residual of the PD operator — the eq.-11 proxy:
    max of ``|w+ - w| / tau`` and ``|u+ - u| / sigma`` (order-independent,
    so every backend computes the identical residual from identical
    iterates).  ``lanes``: the state carries a leading lane axis, and the
    residual is one per lane, (L,)."""
    with _scope(_prof.PHASE_RESIDUAL):
        dw = torch.abs(w_new - w) / _col(tau)
        du = torch.abs(u_new - u) / _col(sigma)
        if lanes:
            return torch.maximum(dw.flatten(1).amax(dim=1),
                                 du.flatten(1).amax(dim=1))
        return torch.maximum(torch.max(dw), torch.max(du))


def certificate(problem, w: torch.Tensor, u: torch.Tensor, *,
                gap_terms=None) -> dict:
    """Optimality diagnostics from the coupled conditions (paper eq. 11).

    * dual feasibility (regularizer-defined; <= 0 means feasible),
    * stationarity residual at labeled nodes for the squared loss,
    * for squared loss + TV, the true duality gap :func:`optimality_gap`.

    ``gap_terms``: a function of the problem's data that stands in for
    :func:`gap_data_terms` (a lambda path's lanes share one data set, so
    ``api.backends._batched_certificate`` computes its terms once).
    """
    from repro_torch.api.losses import SquaredLoss
    from repro_torch.api.regularizers import TotalVariation

    diag = {"dual_infeasibility": problem.regularizer.dual_infeasibility(
        u, problem.graph, problem.lam)}
    if isinstance(problem.loss, SquaredLoss):
        data = problem.data
        pred = torch.einsum("vmn,vn->vm", data.x, w)
        r = (pred - data.y) * data.sample_mask
        grad = 2.0 * torch.einsum("vm,vmn->vn", r,
                                  data.x) / data.counts()[:, None]
        grad = grad * data.labeled_mask[:, None]
        station = grad + (problem.graph.incidence_transpose_apply(u)
                          * data.labeled_mask[:, None])
        diag["stationarity_residual_labeled"] = torch.max(
            torch.abs(station))
        if isinstance(problem.regularizer, TotalVariation):
            terms = None if gap_terms is None else gap_terms(data)
            diag["optimality_gap"] = optimality_gap(problem, w, u,
                                                    terms=terms)
    return diag


#: Jacobi sweeps of :func:`sym_pinv` past n = 2 (converged to float
#: resolution at n <= 32, ``tests/test_torch_certificate.py``); wider
#: matrices take a third more (at n = 64 a half-rank matrix is 8e-5 from
#: its float64 pinv after 8 sweeps, 8e-6 after 12)
_JACOBI_SWEEPS = 8
_JACOBI_SWEEPS_WIDE = 12


def jacobi_sweeps(n: int) -> int:
    """The Jacobi sweeps :func:`sym_pinv` (and its kernel) run at width
    ``n``: one round is exact at n <= 2."""
    if n <= 2:
        return 1
    return _JACOBI_SWEEPS if n <= 32 else _JACOBI_SWEEPS_WIDE


def _jacobi_plan(n: int, dtype, device) -> list:
    """The rounds of disjoint (p, q) pairs, p < q, that cover every pair
    once (the round-robin order: n - 1 rounds of n // 2 pairs, n rounds
    for an odd n, one index resting in each), built on ``device`` with
    no copy from the host.  Per round: the flat indices of its (p, q),
    (p, p) and (q, q) entries, and the basis that turns its (c - 1, s)
    into its rotation J - I (c at (p, p) and (q, q), s at (p, q), -s at
    (q, p)) with one matrix product."""
    m = n + n % 2                              # seats, one empty if odd
    k = n // 2
    rounds = torch.arange(m - 1, device=device)[:, None]
    seat = torch.arange(m, device=device)[None, :]
    # seat 0 stays, the others turn one place a round
    at = torch.where(seat == 0, 0, 1 + (seat - 1 - rounds) % (m - 1))
    half = torch.arange(m // 2, device=device)
    p = torch.minimum(at[:, half], at[:, m - 1 - half])
    q = torch.maximum(at[:, half], at[:, m - 1 - half])
    if n % 2:                                  # drop the empty seat's pair
        empty = 1 + (rounds - 1) % (m - 1)     # the seat of index n
        skip = torch.minimum(empty, m - 1 - empty)
        pair = torch.arange(k, device=device)[None, :]
        keep = pair + (pair >= skip).to(pair.dtype)
        p, q = p.gather(1, keep), q.gather(1, keep)
    one = torch.ones(p.shape, dtype=dtype, device=device)
    basis = torch.zeros((m - 1, 2 * k, n * n), dtype=dtype, device=device)
    basis[:, :k].scatter_(2, torch.stack([p * n + p, q * n + q], -1),
                          torch.stack([one, one], -1))
    basis[:, k:].scatter_(2, torch.stack([p * n + q, q * n + p], -1),
                          torch.stack([one, -one], -1))
    flat = torch.cat([p * n + q, p * n + p, q * n + q], dim=1)
    return [(flat[r], basis[r]) for r in range(m - 1)]


def sym_pinv(a: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse of a batch of symmetric matrices (..., n, n)
    without a host synchronization: ``torch.linalg.pinv`` checks its
    solver's status on the host (on the card, a transfer and a wait),
    so the eigen-decomposition here is Jacobi in tensor ops over the
    batch, each round rotating a set of disjoint (p, q) pairs at once
    as one rotation J (A <- J^T A J, V <- V J: exact after one round at
    n <= 2, converged to float resolution within ``_JACOBI_SWEEPS``
    sweeps at the port's widths), with the eigenvalues below
    ``10 * n * eps * max |lambda|`` cut as the reference's
    ``jnp.linalg.pinv`` cuts singular values by default.  The plain
    version of ``kernels/sym_pinv.py``, which the certificate runs on the
    card (:func:`certificate_pinv`)."""
    n, batch = a.shape[-1], a.shape[:-2]
    m = math.prod(batch)
    a = a.reshape((m, n, n))
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(a)
    eye = torch.eye(n, dtype=a.dtype, device=a.device).reshape(1, n * n)
    plan = _jacobi_plan(n, a.dtype, a.device)
    for _ in range(jacobi_sweeps(n)):
        for flat, basis in plan:
            k = basis.shape[0] // 2
            entries = a.reshape((m, n * n))[:, flat]
            apq, app, aqq = (entries[:, :k], entries[:, k:2 * k],
                             entries[:, 2 * k:])
            theta = (aqq - app) / (2.0 * apq)
            t = torch.sign(theta) / (torch.abs(theta)
                                     + torch.sqrt(theta * theta + 1.0))
            t = torch.where(apq == 0.0, torch.zeros_like(t),
                            torch.where(theta == 0.0, torch.ones_like(t), t))
            c = torch.rsqrt(t * t + 1.0)
            rot = (torch.cat([c - 1.0, t * c], dim=1) @ basis
                   + eye).reshape((m, n, n))
            a = rot.transpose(1, 2) @ a @ rot
            v = v @ rot
    lam = torch.diagonal(a, dim1=-2, dim2=-1)
    cut = (10.0 * n * torch.finfo(a.dtype).eps
           * torch.amax(torch.abs(lam), dim=-1, keepdim=True))
    inv = torch.where(torch.abs(lam) > cut, 1.0 / lam,
                      torch.zeros_like(lam))
    out = torch.einsum("...ik,...k,...jk->...ij", v, inv, v)
    return out.reshape(batch + (n, n))


def certificate_pinv(a: torch.Tensor) -> torch.Tensor:
    """The certificate's pseudo-inverse of ``a`` (..., n, n): on the card
    the ``sym_pinv`` kernel (one launch, no host read), at widths it takes
    (``kernels.sym_pinv.takes``); else, and on the CPU,
    :func:`sym_pinv`."""
    if a.device.type == "cuda":
        from repro_torch.kernels import sym_pinv as kernel

        n = a.shape[-1]
        if kernel.takes(n):
            return kernel.sym_pinv(a.contiguous(), sweeps=jacobi_sweeps(n))
    return sym_pinv(a)


def gap_data_terms(data) -> tuple:
    """The part of :func:`optimality_gap` that depends on the data alone:
    each node's Q_i = X_i^T X_i / m_i, c_i = X_i^T y_i / m_i, y_i^T y_i /
    m_i and pinv(Q_i) (:func:`certificate_pinv`: one ``sym_pinv`` launch
    on the card).  The reference vmaps its certificate over the lanes of
    a lambda path only, so its pinv runs once a path; computing these
    once and passing them to each lane's gap does the same."""
    cnt = data.counts()[:, None]
    xm = data.x * data.sample_mask[..., None]
    q = torch.einsum("vmn,vmk->vnk", xm, data.x) / cnt[..., None]
    c = torch.einsum("vmn,vm->vn", xm, data.y) / cnt
    yty = torch.sum(data.y ** 2 * data.sample_mask, dim=1) / cnt[:, 0]
    return q, c, yty, certificate_pinv(q)


def optimality_gap(problem, w: torch.Tensor, u: torch.Tensor, *,
                   terms: tuple | None = None) -> torch.Tensor:
    """True eq.-11 duality gap for squared loss + TV: ``P(w) - g(u)``.

    At the feasible dual point ``clip(u, +-lam A_e)`` the Lagrangian dual
    is ``g(u) = sum_i min_{w_i in B_R} [ell_i(w_i) + z_i^T w_i]`` with
    ``z = D^T u`` and ``R = 2 max_i |w_i|_2 + 1``.  Labeled nodes solve
    the regularized normal equations via pinv with the first-order ball
    bound for null-space components; unlabeled nodes are exact:
    ``-R |z_i|``.  Weak duality makes the gap a certified upper bound on
    ``P(w) - P*`` (see ``repro.engine.step.optimality_gap``).  The pinv
    is :func:`certificate_pinv`, so the certificate reads nothing on the
    host.  ``terms``: the problem's :func:`gap_data_terms`, where the
    caller has them (the same bits as computing them here).
    """
    data = problem.data
    lam_a = (problem.lam * problem.graph.weights)[:, None]
    u_feas = torch.minimum(torch.maximum(u, -lam_a), lam_a)
    z = problem.graph.incidence_transpose_apply(u_feas)        # (V, n)
    q, c, yty, pinv = gap_data_terms(data) if terms is None else terms
    radius = 2.0 * torch.max(torch.linalg.norm(w, dim=1)) + 1.0

    rhs = c - 0.5 * z
    w_star = torch.einsum("vnk,vk->vn", pinv, rhs)
    lval = (torch.einsum("vn,vnk,vk->v", w_star, q, w_star)
            - 2.0 * torch.sum(c * w_star, dim=1) + yty)
    # grad of f(w) = ell(w) + z^T w at w*: 2 (Q w* - rhs)
    grad = 2.0 * (torch.einsum("vnk,vk->vn", q, w_star) - rhs)
    g_lab = (lval + torch.sum(z * w_star, dim=1)
             - 2.0 * radius * torch.linalg.norm(grad, dim=1))
    g_unl = -radius * torch.linalg.norm(z, dim=1)
    g = torch.sum(torch.where(data.labeled_mask > 0, g_lab, g_unl))
    return (problem.objective(w) - g).to(torch.float32)
