"""CUDA kernel for Hopper: batched node-wise affine map (paper eq. 21).

Replaces the Pallas TPU kernel ``src/repro/kernels/ridge_prox.py:
batched_affine``.  The kernel (``src/repro_torch/csrc/ridge_prox.cu``)
computes w_i = P_i v_i for every node, one thread per output element,
summing in float32 with k ascending; its source note says what bounds it
(bytes) and how the design answers that.
:func:`kernels.ref.batched_affine_ref` is its plain version.
``kernels/_build.py`` builds it on first use.

This wrapper takes CUDA tensors only and raises on anything it does not
take; ``kernels.ops.batched_affine`` sends CPU tensors to the plain
version.  ``batched_affine.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor as _check

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]


def batched_affine(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w_i = P_i v_i on the card for ``p`` (V, n, n) and ``v`` (V, n),
    both float32 and contiguous.  Returns a fresh (V, n) tensor; launches
    on the current stream and does not synchronize."""
    device = v.device
    if device.type != "cuda":
        raise ValueError(f"batched_affine launches on CUDA tensors; got "
                         f"{device} (kernels.ops.batched_affine sends CPU "
                         "tensors to the plain version)")
    if v.ndim != 2:
        raise ValueError(f"v must be (V, n), got {tuple(v.shape)}")
    nodes, n = v.shape
    _check("p", p, (nodes, n, n), torch.float32, device)
    _check("v", v, (nodes, n), torch.float32, device)
    out = torch.empty_like(v)
    if v.numel() == 0:                 # a grid of 0 blocks cannot launch
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _build.entry("batched_affine_launch", _ARGTYPES)(
            p.data_ptr(), v.data_ptr(), out.data_ptr(), nodes, n, stream)
    if err != 0:
        raise RuntimeError(f"batched_affine launch failed: CUDA error {err}")
    batched_affine.launches += 1
    return out


batched_affine.launches = 0
