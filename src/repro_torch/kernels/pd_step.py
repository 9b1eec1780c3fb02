"""CUDA kernel for Hopper: fused primal-dual step (Algorithm 1, eqs. 14-15).

Replaces the Pallas TPU kernel ``src/repro/kernels/pd_step.py:
fused_pd_step``.  The kernel (``src/repro_torch/csrc/pd_step.cu``) runs
one whole step over the edge-blocked layout — D^T u gather, squared-loss
prox, D(2w+ - w), tv / tv2 dual resolvent, KM relaxation, and optionally
the eq.-11 residual and ``iters > 1`` on a single-block layout — as one
cooperative launch; its source note says what bounds it (bytes) and how
the design answers that.  :func:`kernels.ref.fused_pd_step_ref` is its
plain version.

Build: on first use the source is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C entry point under
``build/repro_torch_kernels/`` at the repository root (named by a hash
of the source and flags, so an edited source rebuilds), and loaded with
``ctypes``.  Nothing is built or loaded at import.

This wrapper takes CUDA tensors only and raises on anything it does not
take; ``kernels.ops.pd_step`` sends CPU tensors to the plain version.
``fused_pd_step.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pd_step.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
MAX_FEATURES = 4           # the kernel's widest per-thread register tile

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the fused_pd_step kernel is "
                           "built on a machine with the CUDA toolkit")
    return found


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet.

    Returns ``(library path, compiler output)``; ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel) and
    forces a rebuild so the output is there to read.
    """
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"pd_step-{key[:16]}.so"
    if lib.exists() and not verbose:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, *extra, "-o", tmp, str(_SOURCE)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.fused_pd_step_launch
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([ptr] * 15 + [i64] * 4 + [i32] * 3
                       + [ctypes.c_float] + [i32] * 3 + [ptr])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
        err = _lib().fused_pd_step_launch(
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
