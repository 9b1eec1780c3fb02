"""CUDA kernel for Hopper: pseudo-inverse of a batch of symmetric matrices.

The eq.-11 certificate's pseudo-inverse (``engine/step.py:
optimality_gap``).  It ports no TPU kernel: the reference calls
``jnp.linalg.pinv`` there.  The kernel (``src/repro_torch/csrc/
sym_pinv.cu``) runs the cyclic Jacobi of its plain version,
:func:`repro_torch.engine.step.sym_pinv`, with the same round-robin
pairs, sweeps and eigenvalue cut, in one of three variants by width
(:func:`variant`): ``"thread"`` (a thread a matrix in registers, n <= 4;
the main path's n = 2), ``"warp"`` (a warp a matrix in its slice of
shared memory, n <= 32) and ``"block"`` (a thread block a matrix); each
does every entry's float operations in the same order, so all three give
the same bits.  Its source note says what bounds it.  It reads nothing
back to the host, so it runs under ``torch.cuda.set_sync_debug_mode(
"error")`` and inside a CUDA-graph capture.  A width whose matrix and
rotations (2 n^2 floats) pass a block's shared memory is refused
(:func:`takes`: n <= 169 on the H100); ``engine.step.optimality_gap``
keeps the plain version there.

This wrapper takes CUDA tensors only and raises on anything it does not
take.  ``sym_pinv.launches`` counts the launches (a call inside a
CUDA-graph capture records the kernel and is not counted).
``kernels/_build.py`` builds it on first use.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

#: the kernel's variants, in the order of ``csrc/sym_pinv.cu:Variant``
VARIANTS = ("thread", "warp", "block")

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def plan(n: int) -> tuple[int, int, str]:
    """``(bytes, limit, variant)``: the variant width ``n`` gets, the
    shared memory a block of it takes, and the most a block may take
    (``csrc/sym_pinv.cu:sym_pinv_plan``); builds the library on first
    use."""
    need, limit, chosen = (ctypes.c_longlong(), ctypes.c_longlong(),
                           ctypes.c_int())
    err = _build.entry("sym_pinv_plan",
                       [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
                        ctypes.POINTER(ctypes.c_longlong),
                        ctypes.POINTER(ctypes.c_int)])(
        n, ctypes.byref(need), ctypes.byref(limit), ctypes.byref(chosen))
    if err != 0:
        raise RuntimeError(f"sym_pinv_plan failed: CUDA error {err}")
    return need.value, limit.value, VARIANTS[chosen.value]


def variant(n: int) -> str:
    """The variant the kernel runs at width ``n``: ``"thread"``,
    ``"warp"`` or ``"block"``."""
    return plan(int(n))[2]


def takes(n: int) -> bool:
    """Whether the kernel takes matrices of width ``n``."""
    need, limit, _ = plan(int(n))
    return need <= limit


def sym_pinv(a: torch.Tensor, *, sweeps: int) -> torch.Tensor:
    """Pseudo-inverse of each symmetric float32 matrix of ``a`` (..., n,
    n), contiguous on the card, after ``sweeps`` Jacobi sweeps (the plain
    version's count, ``engine.step.jacobi_sweeps``).  Returns a fresh
    tensor; launches once on the current stream and does not
    synchronize."""
    device = a.device
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"sym_pinv takes (..., n, n) matrices, got "
                         f"{tuple(a.shape)}")
    if a.dtype != torch.float32:
        raise TypeError(f"sym_pinv takes float32, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("sym_pinv's input must be contiguous")
    if device.type != "cuda":
        raise ValueError(f"sym_pinv launches on CUDA tensors; got {device} "
                         "(engine.step.sym_pinv is the plain version)")
    n = a.shape[-1]
    need, limit, _ = plan(n)
    if need > limit:
        raise NotImplementedError(
            f"the sym_pinv kernel keeps a matrix and its rotations (2 n^2 "
            f"floats) in one block's shared memory, at most {limit} bytes; "
            f"n = {n} needs {need} (engine.step.sym_pinv takes such widths)")
    batch = math.prod(a.shape[:-2])
    out = torch.empty_like(a)
    if batch == 0:                     # a grid of 0 blocks cannot launch
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _build.entry("sym_pinv_launch", _ARGTYPES)(
            a.data_ptr(), out.data_ptr(), batch, n, int(sweeps), stream)
    if err != 0:
        raise RuntimeError(f"sym_pinv launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        sym_pinv.launches += 1
    return out


sym_pinv.launches = 0
