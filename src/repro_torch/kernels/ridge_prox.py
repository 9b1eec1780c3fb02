"""CUDA kernel for Hopper: batched node-wise affine map (paper eq. 21).

Replaces the Pallas TPU kernel ``src/repro/kernels/ridge_prox.py:
batched_affine``.  The kernel (``src/repro_torch/csrc/ridge_prox.cu``)
computes w_i = P_i v_i for every node, one thread per output element,
summing in float32 with k ascending; its source note says what bounds it
(bytes) and how the design answers that.  A leading lane axis, v (L, V,
n) with one P (V, n, n) shared by every lane or P (L, V, n, n) per lane,
runs in the same one launch (the reference gets it from ``jax.vmap``); a
shared P is read in place, never copied L times.
:func:`kernels.ref.batched_affine_ref` is its plain version.
``kernels/_build.py`` builds it on first use.

This wrapper takes CUDA tensors only and raises on anything it does not
take; ``kernels.ops.batched_affine`` sends CPU tensors to the plain
version.  ``batched_affine.launches`` counts the launches, and
``batched_affine.lane_launches`` those over more than one lane, by P's
kind (``"shared"`` or ``"per_lane"``); a call inside a CUDA-graph capture
records the kernel and is not counted.  The kernel counts its own runs on
the card, replays included (``_build.executions``).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor as _check

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p]


def batched_affine(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w_i = P_i v_i on the card for ``p`` (V, n, n) and ``v`` (V, n),
    both float32 and contiguous; with lanes, ``v`` (L, V, n) and ``p``
    (V, n, n) shared by every lane or (L, V, n, n) per lane.  Returns a
    fresh tensor of v's shape; launches once, on the current stream, and
    does not synchronize."""
    device = v.device
    if device.type != "cuda":
        raise ValueError(f"batched_affine launches on CUDA tensors; got "
                         f"{device} (kernels.ops.batched_affine sends CPU "
                         "tensors to the plain version)")
    if v.ndim not in (2, 3):
        raise ValueError(f"v must be (V, n) or (L, V, n), got "
                         f"{tuple(v.shape)}")
    lanes = v.shape[0] if v.ndim == 3 else 1
    nodes, n = v.shape[-2:]
    shared = p.ndim == 3
    _check("p", p, (nodes, n, n) if shared else tuple(v.shape) + (n,),
           torch.float32, device)
    _check("v", v, tuple(v.shape), torch.float32, device)
    out = torch.empty_like(v)
    if v.numel() == 0:                 # a grid of 0 blocks cannot launch
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _build.entry("batched_affine_launch", _ARGTYPES)(
            p.data_ptr(), v.data_ptr(), out.data_ptr(), lanes, nodes, n,
            int(shared), _build.execution_counter("batched_affine", device),
            stream)
    if err != 0:
        raise RuntimeError(f"batched_affine launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        batched_affine.launches += 1
        if lanes > 1:
            batched_affine.lane_launches["shared" if shared
                                         else "per_lane"] += 1
    return out


batched_affine.launches = 0
batched_affine.lane_launches = collections.Counter()
