"""CUDA kernel for Hopper: fused primal-dual step (Algorithm 1, eqs. 14-15).

Replaces the Pallas TPU kernel ``src/repro/kernels/pd_step.py:
fused_pd_step``.  The kernel (``src/repro_torch/csrc/pd_step.cu``) runs
one whole step over the edge-blocked layout — D^T u gather, squared-loss
prox, D(2w+ - w), tv / tv2 dual resolvent, KM relaxation, and optionally
the eq.-11 residual and ``iters > 1`` on a single-block layout — as one
cooperative launch; its source note says what bounds it (bytes) and how
the design answers that.  :func:`kernels.ref.fused_pd_step_ref` is its
plain version.

Build: ``kernels/_build.py`` compiles it with the port's other CUDA
sources into one shared library on first use; nothing is built or loaded
at import.

This wrapper takes CUDA tensors only and raises on anything it does not
take; ``kernels.ops.pd_step`` sends CPU tensors to the plain version.
``fused_pd_step.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor as _check

MAX_FEATURES = 4           # the kernel's widest per-thread register tile

_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = ([_PTR] * 15 + [_I64] * 4 + [_I32] * 3 + [ctypes.c_float]
             + [_I32] * 3 + [_PTR])


def fused_pd_step(w_store: torch.Tensor, u_store: torch.Tensor,
                  inc_edges: torch.Tensor, inc_signs: torch.Tensor,
                  params: tuple, tau: torch.Tensor,
                  src: torch.Tensor, dst: torch.Tensor, sigma: torch.Tensor,
                  la: torch.Tensor, *, loss, reg, pkeys: tuple,
                  block_nodes: int, block_edges: int,
                  kn: int, klo: int, khi: int, rho: float = 1.0,
                  iters: int = 1, compute_residual: bool = False):
    """Fused PD step on the card (storage shapes as
    :func:`kernels.ref.fused_pd_step_ref`).  Returns fresh tensors
    (w_new (nb*BV, n), u_new (nb*EB, n)); with ``compute_residual`` also
    the f32 scalar eq.-11 residual of the call (max over nodes and edges,
    and over iterations when ``iters > 1``).  Launches on the current
    stream and does not synchronize."""
    from repro_torch.api.losses import SquaredLoss
    from repro_torch.api.regularizers import SquaredTV, TotalVariation

    if not isinstance(loss, SquaredLoss) or tuple(pkeys) != ("b", "p"):
        raise NotImplementedError(
            "the fused_pd_step kernel runs the squared loss only (prox "
            "params ('b', 'p')); the lasso and logistic in-kernel proxes "
            "are ROADMAP.md Open items §2 item 1")
    if isinstance(reg, TotalVariation):
        reg_kind = 0
    elif isinstance(reg, SquaredTV):
        reg_kind = 1
    else:
        raise NotImplementedError(
            f"the fused_pd_step kernel has no dual resolvent for {reg!r}")
    device = w_store.device
    if device.type != "cuda":
        raise ValueError(f"fused_pd_step launches on CUDA tensors; got "
                         f"{device} (kernels.ops.pd_step sends CPU tensors "
                         "to the plain version)")
    bv, eb = int(block_nodes), int(block_edges)
    if src.ndim != 2 or src.shape[0] % eb:
        raise ValueError(f"src must be (nb*{eb}, 1), got {tuple(src.shape)}")
    nb = src.shape[0] // eb
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if iters != 1 and nb != 1:
        raise ValueError("multi-iteration fusion requires a single block")
    n = w_store.shape[1]
    if n < 1:
        raise ValueError(f"fused_pd_step needs at least one feature, got {n}")
    if n > MAX_FEATURES:
        raise NotImplementedError(
            f"the fused_pd_step kernel takes 1..{MAX_FEATURES} features, got "
            f"{n}; wider register tiles are ROADMAP.md Open items §2 item 1")
    f32, i32 = torch.float32, torch.int32
    rows = (nb + kn - 1) * bv
    max_deg = inc_edges.shape[1]
    b, p = params
    _check("w_store", w_store, (rows, n), f32, device)
    _check("u_store", u_store, ((nb + klo + khi) * eb, n), f32, device)
    _check("inc_edges", inc_edges, (rows, max_deg), i32, device)
    _check("inc_signs", inc_signs, (rows, max_deg), f32, device)
    _check("params['b']", b, (rows, n), f32, device)
    _check("params['p']", p, (rows, n, n), f32, device)
    _check("tau", tau, (rows, 1), f32, device)
    for name, t, dt in (("src", src, i32), ("dst", dst, i32),
                        ("sigma", sigma, f32), ("la", la, f32)):
        _check(name, t, (nb * eb, 1), dt, device)

    w_new = torch.empty((nb * bv, n), dtype=f32, device=device)
    u_new = torch.empty((nb * eb, n), dtype=f32, device=device)
    z = torch.empty((nb * bv, n), dtype=f32, device=device)
    res = torch.zeros((1,), dtype=f32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = (w_store, u_store, inc_edges, inc_signs, b, p, tau, src, dst,
            sigma, la, w_new, u_new, z, res)
    with torch.cuda.device(device):
        err = _build.entry("fused_pd_step_launch", _ARGTYPES)(
            *(t.data_ptr() for t in ptrs), nb * bv, nb * eb, klo * eb,
            u_store.shape[0], n, max_deg, reg_kind, float(rho),
            int(rho != 1.0), int(iters), int(compute_residual), stream)
    if err != 0:
        raise RuntimeError(f"fused_pd_step launch failed: CUDA error {err}")
    fused_pd_step.launches += 1
    if compute_residual:
        return w_new, u_new, res[0]
    return w_new, u_new


fused_pd_step.launches = 0
