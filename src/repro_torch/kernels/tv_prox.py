"""CUDA kernel for Hopper: edge-wise dual clip (Algorithm 1, step 10).

Replaces the Pallas TPU kernel ``src/repro/kernels/tv_prox.py:tv_prox``.
The kernel (``src/repro_torch/csrc/tv_prox.cu``) clips each row of the
dual signal u (E, n) to +-bound_e, one thread per element; its source
note says what bounds it (bytes) and how the design answers that.
:func:`kernels.ref.tv_prox_ref` is its plain version, equal to it bit for
bit.  ``kernels/_build.py`` builds it on first use.

This wrapper takes CUDA tensors only and raises on anything it does not
take; ``kernels.ops.tv_prox`` sends CPU tensors to the plain version.
``tv_prox.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor as _check

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]


def tv_prox(u: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """Clip each row of ``u`` (E, n) to [-bound_e, +bound_e] on the card
    (``bound`` (E,), both float32 and contiguous).  Returns a fresh
    tensor; launches on the current stream and does not synchronize."""
    device = u.device
    if device.type != "cuda":
        raise ValueError(f"tv_prox launches on CUDA tensors; got {device} "
                         "(kernels.ops.tv_prox sends CPU tensors to the "
                         "plain version)")
    if u.ndim != 2:
        raise ValueError(f"u must be (E, n), got {tuple(u.shape)}")
    e, n = u.shape
    _check("u", u, (e, n), torch.float32, device)
    _check("bound", bound, (e,), torch.float32, device)
    out = torch.empty_like(u)
    if u.numel() == 0:                 # a grid of 0 blocks cannot launch
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _build.entry("tv_prox_launch", _ARGTYPES)(
            u.data_ptr(), bound.data_ptr(), out.data_ptr(), e, n, stream)
    if err != 0:
        raise RuntimeError(f"tv_prox launch failed: CUDA error {err}")
    tv_prox.launches += 1
    return out


tv_prox.launches = 0
