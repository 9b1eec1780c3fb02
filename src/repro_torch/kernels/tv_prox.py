"""CUDA kernel for Hopper: edge-wise dual clip (Algorithm 1, step 10).

Replaces the Pallas TPU kernel ``src/repro/kernels/tv_prox.py:tv_prox``.
The kernel (``src/repro_torch/csrc/tv_prox.cu``) clips each row of the
dual signal u (E, n), float32 or bfloat16, to +-bound_e (float32, rounded
to u's dtype first, as the reference does), one thread per element; its
source note says what bounds it (bytes) and how the design answers that.
A leading lane axis, u (L, E, n) with each lane's bounds (L, E), runs in
the same one launch over the contiguous (L E, n) rows (the reference
gets the axis from ``jax.vmap``).
:func:`kernels.ref.tv_prox_ref` is its plain version, equal to it bit for
bit.  ``kernels/_build.py`` builds it on first use.

This wrapper takes CUDA tensors only and raises on anything it does not
take; ``kernels.ops.tv_prox`` sends CPU tensors to the plain version.
``tv_prox.launches`` counts the launches, and ``tv_prox.lane_launches``
those over more than one lane, by u's dtype; a call inside a CUDA-graph
capture records the kernel and is not counted.  The kernel counts its own
runs on the card, replays included (``_build.executions``).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor as _check

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p]
_STORAGE = {torch.float32: 0, torch.bfloat16: 1}


def tv_prox(u: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Clip each row of ``u`` (E, n) to [-bound_e, +bound_e] on the card
    (``u`` float32 or bfloat16, ``bound`` (E,) float32, both contiguous);
    or each lane of ``u`` (L, E, n) to its own bounds ``bound`` (L, E).
    Returns a fresh tensor of u's dtype; launches once, on the current
    stream, and does not synchronize."""
    device = u.device
    if device.type != "cuda":
        raise ValueError(f"tv_prox launches on CUDA tensors; got {device} "
                         "(kernels.ops.tv_prox sends CPU tensors to the "
                         "plain version)")
    if u.ndim not in (2, 3):
        raise ValueError(f"u must be (E, n) or (L, E, n), got "
                         f"{tuple(u.shape)}")
    lanes = u.shape[0] if u.ndim == 3 else 1
    n = u.shape[-1]
    if u.dtype not in _STORAGE:
        raise TypeError(f"tv_prox clips float32 or bfloat16, got {u.dtype}")
    _check("u", u, tuple(u.shape), u.dtype, device)
    _check("bound", bound, tuple(u.shape[:-1]), torch.float32, device)
    out = torch.empty_like(u)
    if u.numel() == 0:                 # a grid of 0 blocks cannot launch
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _build.entry("tv_prox_launch", _ARGTYPES)(
            u.data_ptr(), bound.data_ptr(), out.data_ptr(), bound.numel(),
            n, _STORAGE[u.dtype],
            _build.execution_counter("tv_prox", device), stream)
    if err != 0:
        raise RuntimeError(f"tv_prox launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        tv_prox.launches += 1
        if lanes > 1:
            tv_prox.lane_launches[str(u.dtype).removeprefix("torch.")] += 1
    return out


tv_prox.launches = 0
tv_prox.lane_launches = collections.Counter()
