"""Algorithm 1 of arXiv:2010.14159 (networked federated learning by
total-variation minimization), in plain PyTorch.

This is the benchmark's yardstick: it imports nothing of the program
under test and takes nothing the program made.  It reads the raw edge
list and the node-local datasets the benchmark generated and works out
everything else itself: the stepsizes of eq. 13 (tau_i = 1/deg_i,
sigma_e = 1/2), the primal update of each loss (its module in
``perfbench/losses/``: eq. 21's closed form for the squared loss,
Newton steps for the logistic loss), the dual
update (the clip of step 10), the Krasnosel'skii-Mann relaxation with
its re-projection, and the eq.-11 fixed-point residual that decides a
tol solve's stop.

One step, on state (w, u), with D the signed edge-node incidence
((D w)_e = w_i - w_j for e = {i, j}, i < j):

    w+ = PU(w - tau * D^T u)
    u+ = clip(u + sigma * D (2 w+ - w), +-lam A_e)
    w  <- w + rho (w+ - w)
    u  <- clip(u + rho (u+ - u), +-lam A_e)

and the step's residual max(|w_new - w_old| / tau, |u_new - u_old| /
sigma), the max over the iterations of a metric block being the
block's.  A state may carry a leading lane axis (one lambda a lane).

The arithmetic runs in the dtype given (float64 for the comparisons
that decide ``correct``).  Departures from the paper: the logistic
primal update takes a fixed number of Newton steps (the configuration's
``num_inner``) rather than an exact prox; D^T u is a scatter-add whose
summation order is not fixed.
"""
from __future__ import annotations

import torch

from perfbench import losses

#: a stop is judged acceptable within this share of tol: the rounding of
#: a residual that lands on tol (``solve_to_stop``)
STOP_MARGIN = 1e-3


class Alg1:
    """Algorithm 1 on one graph and one dataset, at one or several
    lambdas.

    ``src``/``dst`` (E,) int64 edge endpoints with src < dst, ``weights``
    (E,) edge weights A_e; ``x`` (V, m, n), ``y`` (V, m) and ``labeled``
    (V,) bool the node-local data (unlabeled nodes carry no loss);
    ``lams`` a float or a list of floats (a lane each); ``loss_kwargs``
    the configuration's keywords of the loss (``perfbench/losses/``).
    """

    def __init__(self, src, dst, weights, x, y, labeled, *, loss: str,
                 lams, rho: float, loss_kwargs: dict | None = None,
                 dtype=torch.float64):
        self.dtype = dtype
        dev = x.device
        self.num_nodes = int(x.shape[0])
        self.src = src.to(dev, torch.int64)
        self.dst = dst.to(dev, torch.int64)
        v = self.num_nodes
        deg = (torch.bincount(self.src, minlength=v)
               + torch.bincount(self.dst, minlength=v)).to(dtype)
        self.tau = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                               torch.ones_like(deg))[:, None]
        self.sigma = 0.5
        self.rho = float(rho)
        self.lanes = isinstance(lams, (list, tuple))
        lam = torch.tensor(lams if self.lanes else [lams], dtype=dtype,
                           device=dev)
        bound = lam[:, None] * weights.to(dev, dtype)[None, :]
        self.bound = (bound if self.lanes else bound[0])[..., None]
        self.lab = torch.nonzero(labeled.to(dev)).reshape(-1)
        self.prox_l = losses.load(loss).Prox(
            x[self.lab].to(dtype), y[self.lab].to(dtype), self.tau[self.lab],
            **(loss_kwargs or {}))

    # -- the operators ------------------------------------------------------
    def gather(self, u: torch.Tensor) -> torch.Tensor:
        """D^T u: (..., E, n) -> (..., V, n)."""
        out = u.new_zeros(u.shape[:-2] + (self.num_nodes, u.shape[-1]))
        out.index_add_(-2, self.src, u)
        out.index_add_(-2, self.dst, u, alpha=-1.0)
        return out

    def diff(self, z: torch.Tensor) -> torch.Tensor:
        """D z: (..., V, n) -> (..., E, n), gathered feature-major (a row
        of n = 2 float64s takes a gather kernel that is ~70x slower on
        the H100 than one of single values)."""
        zt = z.transpose(-1, -2).contiguous()
        d = zt.index_select(-1, self.src) - zt.index_select(-1, self.dst)
        return d.transpose(-1, -2)

    def clip(self, u: torch.Tensor) -> torch.Tensor:
        return torch.maximum(torch.minimum(u, self.bound), -self.bound)

    def prox(self, v: torch.Tensor) -> torch.Tensor:
        """The primal update of every labeled node (identity elsewhere),
        by the loss's own module (``perfbench/losses/<loss>.py``)."""
        zl = self.prox_l(v.index_select(-2, self.lab))
        out = v.clone()
        out.index_copy_(-2, self.lab, zl)
        return out

    # -- iterations ---------------------------------------------------------
    def step(self, w: torch.Tensor, u: torch.Tensor):
        """One relaxed primal-dual step; returns (w, u, residual) with
        the residual (one a lane) on the device."""
        wp = self.prox(w - self.tau * self.gather(u))
        up = self.clip(u + self.sigma * self.diff(2.0 * wp - w))
        w_new = w + self.rho * (wp - w)
        u_new = self.clip(u + self.rho * (up - u))
        rw = ((w_new - w).abs() / self.tau).amax(dim=(-2, -1))
        ru = ((u_new - u).abs() / self.sigma).amax(dim=(-2, -1))
        return w_new, u_new, torch.maximum(rw, ru)

    def block(self, w, u, iters: int):
        """``iters`` steps; returns (w, u, the block's max residual)."""
        res = None
        for _ in range(iters):
            w, u, r = self.step(w, u)
            res = r if res is None else torch.maximum(res, r)
        return w, u, res

    def zeros(self, n: int):
        """The zero state (w, u) of every lane."""
        lead = tuple(self.bound.shape[:-2])
        dev = self.src.device
        return (torch.zeros(lead + (self.num_nodes, n), dtype=self.dtype,
                            device=dev),
                torch.zeros(lead + (self.src.shape[0], n), dtype=self.dtype,
                            device=dev))


def solve_to_stop(alg: Alg1, w, u, *, program_iters: int, tol: float,
                  metric_every: int, budget: int):
    """Follow a tol solve from (w, u) and judge the program's stop.

    The tol solve's rule: stop after the first metric block whose
    residual is <= tol, or at the budget.  The reference runs its own
    blocks until it has passed both the program's stopping iteration
    and its own stop.  The program's stop is *acceptable* when no
    earlier block of the reference reads <= tol (1 - STOP_MARGIN) and
    the stopping block reads <= tol (1 + STOP_MARGIN) (or the budget is
    spent).
    Returns ``(w, u, reference stop, acceptable)``: the reference's
    state at the program's stop where it is acceptable, else at the
    reference's own stop, which the program's answer is then judged
    against."""
    me = metric_every
    k, own_stop, at_prog, at_own = 0, None, None, None
    early = False                       # a block before the program's <= tol
    stop_ok = program_iters >= budget
    while k < budget:
        w, u, res = alg.block(w, u, me)
        k += me
        r = float(res)
        if k < program_iters and r <= tol * (1.0 - STOP_MARGIN):
            early = True
        if k == program_iters:
            at_prog = (w, u)
            stop_ok = stop_ok or r <= tol * (1.0 + STOP_MARGIN)
        if own_stop is None and r <= tol:
            own_stop, at_own = k, (w, u)
        if k >= program_iters and own_stop is not None:
            break
    if own_stop is None:
        own_stop, at_own = k, (w, u)
    acceptable = at_prog is not None and stop_ok and not early
    w, u = at_prog if acceptable else at_own
    return w, u, own_stop, acceptable


def max_gap(w_prog: torch.Tensor, w_ref: torch.Tensor) -> float:
    """The widest gap of an answer: max |w_prog - w_ref| over every entry,
    as a share of max |w_ref|."""
    w_ref = w_ref.to(torch.float64)
    gap = (w_prog.to(w_ref.device, torch.float64) - w_ref).abs().max()
    return float(gap / w_ref.abs().max().clamp(min=1e-30))
