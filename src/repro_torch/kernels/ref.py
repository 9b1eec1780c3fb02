"""Plain PyTorch versions of the port's kernels.

Each function states what the matching kernel computes, runs on any
device, and is what ``kernels.ops`` runs for a tensor on the CPU.  Each
also takes the leading lane axis its kernel takes (a lambda path or a
batch of problems; the reference gets it from ``jax.vmap``).  The
fused primal-dual window step is not restated here: it is the canonical
:func:`repro_torch.engine.step.pd_step` evaluated through a
:class:`repro_torch.engine.executors.WindowExecutor`, as in the
reference's ``repro.kernels.ref``.  Storage is float32 or bfloat16;
arithmetic is float32 (the reference's precision policy).
"""
from __future__ import annotations

import torch

from repro_torch.engine.executors import WindowExecutor
from repro_torch.engine.step import pd_step as _engine_pd_step


def tv_prox_ref(u: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Edge-wise dual clipping T^(lambda A_e) (paper Algorithm 1, step 10).

    u: (E, n) dual edge signal; bound: (E,) per-edge clip level lambda*A_e.
    With lanes, u (L, E, n) and bound (L, E) (lane l clips to lam_l A_e)
    or (E,) shared by every lane.  The bound is rounded to u's dtype
    before the clip, as the reference kernel does
    (``bound.astype(u.dtype)``), so a bfloat16 ``u`` clips against
    bfloat16 levels and the result stays bfloat16.
    """
    b = bound.to(u.dtype)[..., None]
    return torch.clamp(u, -b, b)


def batched_affine_ref(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Node-wise primal ridge update w_i = P_i @ v_i (paper eq. 21).

    p: (V, n, n); v: (V, n) (already includes the +b_i shift).  With
    lanes, v (L, V, n) and p (V, n, n) shared by every lane or (L, V, n,
    n) per lane.
    """
    if v.ndim == 2:
        return torch.einsum("vnk,vk->vn", p, v)
    return torch.einsum("...vnk,...vk->...vn", p, v)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """Reduced-precision float tensors (bf16 storage) upcast to f32;
    f32, wider floats and integers as they are."""
    if t.is_floating_point() and t.element_size() < 4:
        return t.to(torch.float32)
    return t


def pd_window_step(w_win: torch.Tensor, u_win: torch.Tensor,
                   inc_local: torch.Tensor, inc_signs: torch.Tensor,
                   params_win: tuple, tau_win: torch.Tensor,
                   src_local: torch.Tensor, dst_local: torch.Tensor,
                   sigma: torch.Tensor, la: torch.Tensor, *, loss, reg,
                   pkeys: tuple, klo: int, block_edges: int,
                   rho: float = 1.0):
    """One fused primal-dual step on a stack of B layout windows.

    Builds the window executor and the windowed prox, then runs the
    canonical engine step.  Window shapes (see
    ``core.graph.EdgeBlockLayout``), each with a leading block axis B:
    ``w_win`` (B, NW, n), ``u_win`` (B, EW, n), ``inc_local`` /
    ``inc_signs`` (B, NW, max_deg) with edge ids already relative to the
    window (pre-clipped), ``params_win`` a tuple of per-node prox
    parameter windows (leaves (B, NW, ...), keyed by ``pkeys`` — the
    sorted keys of ``loss.prox_setup``), ``tau_win`` (B, NW, 1), and per
    *owned* edge ``src_local`` / ``dst_local`` (B, EB), ``sigma`` /
    ``la`` (B, EB, 1) with ``la`` the pre-scaled ``lam * A_e`` (the
    canonical step runs at ``lam = 1``).  Returns (w_relaxed_window
    (B, NW, n), u_new_owned (B, EB, n)) in the storage dtype.

    Precision policy (the reference's): ``w_win`` / ``u_win`` and the
    float prox parameter windows may arrive in a reduced storage dtype
    (bf16), while the gather-sums, prox solves and dual resolvent run in
    f32: the window is upcast on entry and the outputs are cast back to
    the storage dtype.  f32 storage is the identity path.
    """
    store = w_win.dtype
    executor = WindowExecutor(
        inc_local=inc_local, inc_signs=inc_signs, src_local=src_local,
        dst_local=dst_local, weights=la, klo=klo, block_edges=block_edges)
    params = dict(zip(pkeys, map(_f32, params_win)))

    def prox(v):
        return loss.prox_apply(params, v)

    w_new, u_new = _engine_pd_step(executor, prox, reg, 1.0, tau_win, sigma,
                                   _f32(w_win), _f32(u_win), rho=rho)
    return w_new.to(store), u_new.to(store)


def window_residual(w_old: torch.Tensor, u_old: torch.Tensor,
                    w_new: torch.Tensor, u_new: torch.Tensor,
                    tau_owned: torch.Tensor,
                    sigma: torch.Tensor) -> torch.Tensor:
    """eq.-11 residual over the windows' *owned* rows: the max of
    ``|w_new - w_old| / tau`` over owned nodes and ``|u_new - u_old| /
    sigma`` over owned edges, across every block, in f32 for bf16
    storage.  Layout padding rows are inert (their state never moves),
    so they contribute 0."""
    rp = torch.max(torch.abs(_f32(w_new) - _f32(w_old)) / _f32(tau_owned))
    rd = torch.max(torch.abs(_f32(u_new) - _f32(u_old)) / _f32(sigma))
    return torch.maximum(rp, rd)


def fused_pd_step_ref(w_store: torch.Tensor, u_store: torch.Tensor,
                      inc_edges: torch.Tensor, inc_signs: torch.Tensor,
                      params: tuple, tau: torch.Tensor,
                      src: torch.Tensor, dst: torch.Tensor,
                      sigma: torch.Tensor, la: torch.Tensor, *, loss, reg,
                      pkeys: tuple, block_nodes: int, block_edges: int,
                      kn: int, klo: int, khi: int, rho: float = 1.0,
                      iters: int = 1, compute_residual: bool = False,
                      out: tuple | None = None,
                      active: torch.Tensor | None = None):
    """Plain version of the fused PD kernel: the window step over every
    block at once (the reference vmaps it).

    Storage shapes (layout order, see ``EdgeBlockLayout``):
      w_store (nb*BV + (kn-1)*BV, n), u_store ((nb+klo+khi)*EB, n),
      inc_edges/inc_signs/tau and every ``params`` leaf padded to the
      same node-store rows, src/dst/sigma/la (nb*EB, 1).
    Returns (w_new (nb*BV, n), u_new (nb*EB, n)) in the storage dtype,
    plus the f32 scalar eq.-11 residual of the call with
    ``compute_residual`` (max over blocks; for ``iters > 1`` the running
    max over iterations).

    Lanes: ``w_store`` (L, rows, n), ``u_store`` (L, urows, n) and ``la``
    (L, nb*EB, 1) stack L problems on one layout whose prox parameters,
    tau and sigma they share (a lambda path); the outputs then carry the
    lane axis and the residual is (L,).  Each lane's windows are more
    windows of the same step, so every lane computes what a one-lane call
    on its inputs computes.  ``iters > 1`` requires nb == 1: the window is
    then the whole graph and the relaxed output feeds straight back in,
    through an f32 carry that is rounded to the storage dtype once, at
    the end (the reference's per-launch rounding).

    ``out`` = (w_out, u_out) receives the result instead of fresh
    tensors (it may be the owned rows of ``w_store`` / ``u_store``: the
    step reads its windows before it writes).  ``active`` (a one-element
    bool tensor, with ``out``) is a tol solve's stop word: where it is
    False, ``out`` keeps what it holds and the residual is 0 — the
    kernel then writes nothing.
    """
    bv, eb = block_nodes, block_edges
    nb = src.shape[0] // eb
    if iters != 1 and nb != 1:
        raise ValueError("multi-iteration fusion requires a single block")
    if active is not None and out is None:
        raise ValueError("active needs out: a stopped launch writes "
                         "nothing, so the outputs must be the state")
    n = w_store.shape[-1]
    nw, ew = kn * bv, (klo + 1 + khi) * eb
    dev = w_store.device
    store = w_store.dtype
    lanes = w_store.shape[0] if w_store.ndim == 3 else None
    nl = lanes or 1

    def rep(t):
        """A shared (nb, ...) window table for every lane's windows."""
        if lanes is None:
            return t
        return t.expand((lanes,) + tuple(t.shape)).reshape(
            (lanes * nb,) + tuple(t.shape[1:]))

    def lane_max(x):
        """(L*nb, ...) per-window values -> (L,) lane maxima."""
        return x.reshape(lanes, -1).amax(dim=1)

    n0 = torch.arange(nb, device=dev) * bv                  # window starts
    e0 = torch.arange(nb, device=dev) * eb
    nrow = n0[:, None] + torch.arange(nw, device=dev)       # (nb, NW)
    erow = e0[:, None] + torch.arange(ew, device=dev)       # (nb, EW)
    w_win = w_store[..., nrow, :].reshape(nl * nb, nw, n)
    u_win = u_store[..., erow, :].reshape(nl * nb, ew, n)
    isg = rep(inc_signs[nrow])
    # prox parameters are read-only across iterations: upcast once here
    params_win = tuple(rep(_f32(a[nrow])) for a in params)
    tau_win = rep(tau[nrow])                                # (nb, NW, 1)
    sg = rep(sigma.reshape(nb, eb, 1))
    bd = la.reshape(nl * nb, eb, 1)
    # storage ids -> window-local (clipped; sign 0 kills stray slots)
    el = rep(torch.clamp(inc_edges[nrow] - e0[:, None, None], 0, ew - 1))
    sl = rep(torch.clamp(src.reshape(nb, eb) - n0[:, None], 0, nw - 1))
    dl = rep(torch.clamp(dst.reshape(nb, eb) - n0[:, None], 0, nw - 1))

    def one(w_, u_):
        return pd_window_step(w_, u_, el, isg, params_win, tau_win, sl, dl,
                              sg, bd, loss=loss, reg=reg, pkeys=pkeys,
                              klo=klo, block_edges=eb, rho=rho)

    tau_own = tau_win[:, :bv]
    lead = () if lanes is None else (lanes,)

    def residual(w_old, u_old, w_n, u_n):
        if lanes is None:
            return window_residual(w_old, u_old, w_n, u_n, tau_own, sg)
        rp = lane_max(torch.abs(_f32(w_n) - _f32(w_old)) / _f32(tau_own))
        rd = lane_max(torch.abs(_f32(u_n) - _f32(u_old)) / _f32(sg))
        return torch.maximum(rp, rd)

    res = torch.zeros(lead, dtype=torch.float32, device=dev)
    if iters == 1:
        w_o, u_o = one(w_win, u_win)
        if compute_residual:
            # owned dual rows sit at window offset klo*EB
            u_owned = u_win[:, klo * eb:(klo + 1) * eb]
            res = residual(w_win[:, :bv], u_owned, w_o[:, :bv], u_o)
        w_new = w_o[:, :bv].reshape(lead + (nb * bv, n))
        u_new = u_o.reshape(lead + (nb * eb, n))
    else:
        # nb == 1 (so kn == 1 and the owned dual rows are the whole
        # window); the carry runs in f32 and rounds once at the end
        w_c, u_c = _f32(w_win), _f32(u_win)
        for _ in range(iters):
            w_n, u_n = one(w_c, u_c)
            if compute_residual:
                res = torch.maximum(res, residual(w_c[:, :bv], u_c,
                                                  w_n[:, :bv], u_n))
            w_c, u_c = w_n, u_n
        w_new = w_c[:, :bv].reshape(lead + (bv, n)).to(store)
        u_new = u_c.reshape(lead + (eb, n)).to(store)
    if out is not None:
        if active is not None:
            flag = active.reshape(())
            w_new = torch.where(flag, w_new, out[0])
            u_new = torch.where(flag, u_new, out[1])
            res = torch.where(flag, res, torch.zeros_like(res))
        out[0].copy_(w_new)
        out[1].copy_(u_new)
        w_new, u_new = out
    return (w_new, u_new, res) if compute_residual else (w_new, u_new)
