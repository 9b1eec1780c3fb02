"""Public entry points for the port's kernels.

Each op launches its CUDA kernel on CUDA tensors and runs the plain
PyTorch version on CPU tensors — the device of the tensors it is given
decides, and nothing else: there is no fallback from the card.  Each
takes a leading lane axis in one call (one launch on the card): a lambda
path or a batch of problems, which the reference gets from ``jax.vmap``.
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.pd_step import fused_pd_step as _fused_pd_step
from repro_torch.kernels.ridge_prox import batched_affine as _affine
from repro_torch.kernels.tv_prox import tv_prox as _tv_prox


def tv_prox(u, bound):
    """Edge-wise dual clip (Algorithm 1 step 10): each row of ``u``
    (E, n) to +-``bound`` (E,), or of ``u`` (L, E, n) to per-lane bounds
    (L, E) or shared ones (E,) — the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    fn = _ref.tv_prox_ref if u.device.type == "cpu" else _tv_prox
    return fn(u, bound)


def batched_affine(p, v):
    """Node-wise ridge primal update w_i = P_i v_i (paper eq. 21) for
    ``p`` (V, n, n), ``v`` (V, n); or ``v`` (L, V, n) with ``p`` shared
    (V, n, n) or per lane (L, V, n, n) — the CUDA kernel for tensors on
    the card, the plain version for tensors on the CPU."""
    fn = _ref.batched_affine_ref if v.device.type == "cpu" else _affine
    return fn(p, v)


def pd_step(w_store, u_store, inc_edges, inc_signs, params, tau, src, dst,
            sigma, la, *, incidence, loss, reg, pkeys, block_nodes,
            block_edges, kn, klo, khi, rho=1.0, iters=1,
            compute_residual=False, out=None, active=None):
    """Fused primal-dual step over an edge-blocked layout (Algorithm 1
    body in one pass): the CUDA kernel for tensors on the card, reading
    the layout's compact incidence ``incidence``
    (``EdgeBlockLayout.compact``); the plain version for tensors on the
    CPU, reading the padded tables ``inc_edges`` / ``inc_signs``.
    ``params`` is the tuple of ``loss.prox_setup`` leaves in ``pkeys``
    (sorted-key) order; shapes, the lane axis, the in-place ``out`` and
    the stop word ``active`` per ``kernels.ref.fused_pd_step_ref``."""
    kw = dict(loss=loss, reg=reg, pkeys=pkeys, block_nodes=block_nodes,
              block_edges=block_edges, kn=kn, klo=klo, khi=khi, rho=rho,
              iters=iters, compute_residual=compute_residual, out=out,
              active=active)
    if w_store.device.type == "cpu":
        return _ref.fused_pd_step_ref(w_store, u_store, inc_edges,
                                      inc_signs, params, tau, src, dst,
                                      sigma, la, **kw)
    return _fused_pd_step(w_store, u_store, params, tau, src, dst, sigma,
                          la, incidence=incidence, **kw)
