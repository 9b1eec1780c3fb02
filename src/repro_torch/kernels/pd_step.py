"""CUDA kernel for Hopper: fused primal-dual step (Algorithm 1, eqs. 14-15).

Replaces the Pallas TPU kernel ``src/repro/kernels/pd_step.py:
fused_pd_step``.  The kernel (``src/repro_torch/csrc/pd_step_impl.cuh``,
instantiated per loss in ``csrc/pd_step*.cu``) runs one whole step over
the edge-blocked layout — D^T u gather, the loss's prox (squared, lasso
ISTA or logistic Newton), D(2w+ - w), tv / tv2 dual resolvent, KM
relaxation, and optionally the eq.-11 residual and ``iters > 1`` on a
single-block layout — as one cooperative launch, in float32 or bfloat16
storage with float32 arithmetic; its source note says what bounds it and
how the design answers that.  It reads the layout's compact incidence
(``EdgeBlockLayout.compact``, passed as ``incidence``), where its plain
version, :func:`kernels.ref.fused_pd_step_ref`, reads the padded tables
``inc_edges`` / ``inc_signs``; the kernel takes no padded tables.

Variants.  Up to ``TILE_FEATURES`` features a node's row is a register
tile of one thread (``csrc/pd_step_impl.cuh``); past it the wide kernel
gives each node to a warp, its prox a row a thread
(``csrc/pd_step_wide.cuh``), for any n.  Each stages its tile's prox
parameters in shared memory where the launch's plan fits a block
(:func:`staging_bytes`: a node's parameters, and over lanes one slot a
lane), and otherwise runs its streamed variant (:func:`streaming_bytes`).
The wide kernel's reads the parameters from device memory with the
staged arithmetic, so the same bits.  The register tile's (the logistic
loss's: ``csrc/pd_step_streamed.cuh``) skips the prox of unlabeled
nodes and gives each labeled node a block, which stages its samples in
shared memory once a step and splits them over its threads: its sums run
in another order, so where both variants apply they agree to float32
rounding, each held to the plain version.  A launch neither plan fits is
refused, naming the limit: the wide logistic variant keeps a node's
Cholesky factor (n (n + 1) / 2 floats) in one warp's shared memory,
which bounds n at 336 in one lane (:func:`kernel_takes`).

Build: ``kernels/_build.py`` compiles it with the port's other CUDA
sources into one shared library on first use; nothing is built or loaded
at import.

A leading lane axis (``w_store`` (L, rows, n), ``u_store`` (L, urows,
n), ``la`` (L, nb*EB, 1): L problems on one layout with one set of prox
parameters, a lambda path) runs in the same single launch; the
reference gets that axis from ``jax.vmap``.

This wrapper takes CUDA tensors only and raises on anything it does not
take; ``kernels.ops.pd_step`` sends CPU tensors to the plain version.
Its checks run before the device check, so the CPU tests reach them.
Each launch runs in one :mod:`repro_torch.obs.profile` range that names
the step phases it fuses (``FUSED_STEP``), while telemetry or a profiler
is on.  ``fused_pd_step.launches`` counts the launches,
``fused_pd_step.variant_launches`` counts them by variant
(:func:`variant_key`: ``"<loss>/<dtype>"``, with ``"/wide"`` past the
register tile and ``"/streamed"`` where the parameters are not staged),
and ``fused_pd_step.lane_launches`` counts those over more than one lane
by the same key.  A call inside a CUDA-graph capture records the kernel
and is not counted: the graph's replays run it.  The kernel counts its
own runs on the card, replays included (``_build.executions``).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_tensor as _check
from repro_torch.obs import profile as _prof

TILE_FEATURES = 16         # the widest per-thread register tile
MAX_LANES = 4096           # lanes of one launch (a shared float each)

# the loss kinds of csrc/pd_step.cuh, with the prox parameters the kernel
# reads (the sorted keys of each loss's prox_setup)
_LOSSES = {"squared": (0, ("b", "p")),
           "lasso": (1, ("labeled", "m", "q", "step", "tau", "xty")),
           "logistic": (2, ("labeled", "m", "mask", "tau", "x", "y"))}
_STORAGE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I64, _I32, _F32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)


class _PdArgs(ctypes.Structure):
    """``repro_pd::PdArgs`` of ``csrc/pd_step.cuh``, field for field."""

    _fields_ = [
        ("w_in", _P), ("u_in", _P), ("in_ptr", _P), ("in_ids", _P),
        ("out_run", _P), ("prm", _P * 6), ("tau", _P), ("src", _P),
        ("dst", _P), ("sigma", _P), ("la", _P), ("w_out", _P), ("u_out", _P),
        ("w_carry", _P), ("u_carry", _P), ("z", _P), ("res", _P),
        ("active", _P),
        ("num_nodes", _I64), ("num_edges", _I64), ("u_offset", _I64),
        ("u_rows", _I64), ("num_in", _I64),
        ("n", _I32), ("reg_kind", _I32), ("relax", _I32),
        ("rho", _F32), ("iters", _I32), ("compute_residual", _I32),
        ("loss_kind", _I32), ("storage", _I32), ("num_samples", _I32),
        ("num_inner", _I32), ("alpha", _F32),
        ("num_lanes", _I64), ("w_in_lane", _I64), ("u_in_lane", _I64),
        ("w_out_lane", _I64), ("u_out_lane", _I64), ("wc_lane", _I64),
        ("uc_lane", _I64), ("la_lane", _I64), ("executions", _P),
        ("force_streamed", _I32), ("work", _P),
    ]


_ARGTYPES = [ctypes.POINTER(_PdArgs), _P]


def _param_shapes(kind: int, rows: int, n: int, params: tuple) -> list:
    """The shape the kernel reads for each prox parameter, in pkeys
    order."""
    if kind == 0:
        return [(rows, n), (rows, n, n)]
    if kind == 1:
        col = (rows, 1)
        return [col, col, (rows, n, n), col, col, (rows, n)]
    ms = params[4].shape[1] if params[4].ndim == 3 else -1
    col = (rows, 1)
    return [col, col, (rows, ms), col, (rows, ms, n), (rows, ms)]


@functools.lru_cache(maxsize=None)
def staging_bytes(kind: int, n: int, num_samples: int,
                  lanes: int = 1) -> tuple[int, int]:
    """``(bytes, limit)``: the shared memory a launch of loss kind
    ``kind`` (``_LOSSES``) at ``n`` features, ``num_samples`` samples a
    node and ``lanes`` lanes plans for a block (the tile's staged prox
    parameters, and over lanes their residual slots), and the most a
    block may take.  The launch's own plan (``csrc/pd_step.cu:
    fused_pd_step_staging``); builds the library on first use."""
    need, limit = ctypes.c_longlong(), ctypes.c_longlong()
    err = _build.entry("fused_pd_step_staging",
                       [_I32, _I32, _I32, _I32,
                        ctypes.POINTER(ctypes.c_longlong),
                        ctypes.POINTER(ctypes.c_longlong)])(
        kind, n, num_samples, lanes, ctypes.byref(need),
        ctypes.byref(limit))
    if err != 0:
        raise RuntimeError(f"fused_pd_step_staging failed: CUDA error {err}")
    return need.value, limit.value


@functools.lru_cache(maxsize=None)
def streaming_bytes(kind: int, n: int, num_samples: int,
                    lanes: int = 1) -> tuple[int, int]:
    """``(bytes, limit)`` as :func:`staging_bytes`, for the streamed
    variant (parameters read from device memory): its slots, and for the
    wide variant its warps' slices (``csrc/pd_step.cu:
    fused_pd_step_streaming``; a register-tile loss with no streamed
    variant reports more than any limit: its staged plan always fits)."""
    need, limit = ctypes.c_longlong(), ctypes.c_longlong()
    err = _build.entry("fused_pd_step_streaming",
                       [_I32, _I32, _I32, _I32,
                        ctypes.POINTER(ctypes.c_longlong),
                        ctypes.POINTER(ctypes.c_longlong)])(
        kind, n, num_samples, lanes, ctypes.byref(need),
        ctypes.byref(limit))
    if err != 0:
        raise RuntimeError(f"fused_pd_step_streaming failed: CUDA error "
                           f"{err}")
    return need.value, limit.value


@functools.lru_cache(maxsize=None)
def streamed_slab_samples(n: int, num_samples: int, lanes: int = 1,
                          dtype: torch.dtype = torch.float32) -> int:
    """The samples of a node that the register-tile logistic streamed
    variant stages in shared memory at ``n`` features (at most
    ``TILE_FEATURES``), ``num_samples`` samples a node, ``lanes`` lanes
    and storage ``dtype``; it reads the rest from device memory in each
    Newton step (``csrc/pd_step.cu:fused_pd_step_streamed_samples``, the
    launch's own plan)."""
    count = ctypes.c_longlong()
    err = _build.entry("fused_pd_step_streamed_samples",
                       [_I32, _I32, _I32, _I32,
                        ctypes.POINTER(ctypes.c_longlong)])(
        n, num_samples, lanes, _STORAGE[dtype], ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"fused_pd_step_streamed_samples failed: CUDA "
                           f"error {err}")
    return count.value


def plan_variant(kind: int, n: int, num_samples: int,
                 lanes: int = 1) -> str | None:
    """The variant a launch of loss kind ``kind`` at ``n`` features,
    ``num_samples`` samples a node and ``lanes`` lanes runs:
    ``"staged"`` where the staging plan fits a block, else
    ``"streamed"`` where that plan fits, else None (refused).  The
    kernel's entry point decides by the same two plans."""
    need, limit = staging_bytes(kind, n, num_samples, lanes)
    if need <= limit:
        return "staged"
    need, limit = streaming_bytes(kind, n, num_samples, lanes)
    return "streamed" if need <= limit else None


def variant_key(name: str, dtype: torch.dtype, n: int, staged: bool) -> str:
    """The launch counters' key of a variant: ``"<loss>/<dtype>"``, with
    ``"/wide"`` past the register tile and ``"/streamed"`` where the
    prox parameters are read from device memory."""
    key = f"{name}/{str(dtype).removeprefix('torch.')}"
    if n > TILE_FEATURES:
        key += "/wide"
    return key if staged else key + "/streamed"


def kernel_takes(loss, n: int, num_samples: int, lanes: int = 1) -> bool:
    """Whether the kernel runs a launch of ``loss`` at ``n`` features,
    ``num_samples`` samples a node and ``lanes`` lanes in one of its
    variants (:func:`plan_variant`).  A loss the kernel has no prox for
    is not refused here (the wrapper refuses it)."""
    name = getattr(loss, "name", None)
    if name not in _LOSSES:
        return True
    return plan_variant(_LOSSES[name][0], n, num_samples, lanes) is not None


def _check_rows(name: str, t: torch.Tensor, shape: tuple,
                dtype: torch.dtype, device: torch.device) -> None:
    """Like ``check_tensor``, but a lane-stacked (L, rows, n) output may
    be a view with any lane stride (the owned rows of lane-stacked
    stores) as long as each lane's rows are contiguous."""
    if t.ndim != 3:
        _check(name, t, shape, dtype, device)
        return
    _check(name, t[0], shape[1:], dtype, device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.stride(0) < t.shape[1] * t.shape[2]:
        raise ValueError(f"{name}: lanes overlap (stride {t.stride()})")


def fused_pd_step(w_store: torch.Tensor, u_store: torch.Tensor,
                  params: tuple, tau: torch.Tensor,
                  src: torch.Tensor, dst: torch.Tensor, sigma: torch.Tensor,
                  la: torch.Tensor, *, incidence: tuple, loss, reg,
                  pkeys: tuple, block_nodes: int, block_edges: int,
                  kn: int, klo: int, khi: int, rho: float = 1.0,
                  iters: int = 1, compute_residual: bool = False,
                  out: tuple | None = None,
                  active: torch.Tensor | None = None,
                  streamed: bool = False):
    """Fused PD step on the card (storage shapes, the lane axis and
    ``out`` / ``active`` as :func:`kernels.ref.fused_pd_step_ref`).
    ``incidence`` is the
    layout's compact incidence ``(in_ptr, in_ids, out_run)``
    (``EdgeBlockLayout.compact``), which the kernel reads where its plain
    version reads the padded tables.  Returns (w_new (nb*BV, n), u_new
    (nb*EB, n)) in the storage dtype — fresh tensors, or the
    ``out`` pair the launch wrote (it may be the owned rows of
    ``w_store`` / ``u_store``: the kernel updates in place safely); with
    ``compute_residual`` also the f32 scalar eq.-11 residual of the call.
    Lane-stacked stores give (L, nb*BV, n) / (L, nb*EB, n) outputs and an
    (L,) residual, one launch for every lane.
    ``active`` (a one-element bool tensor, with ``out``) is the stop word
    of a tol solve: when it is False the launch writes nothing.
    ``streamed`` runs the streamed variant where the staged one would
    run, for checking the two against each other (the wide kernel's give
    the same bits, the register tile's logistic ones agree to float32
    rounding); the register-tile squared and lasso kernels have none.
    Launches on the current stream and does not synchronize."""
    from repro_torch.api.regularizers import SquaredTV, TotalVariation

    name = getattr(loss, "name", None)
    if name not in _LOSSES or tuple(pkeys) != _LOSSES[name][1]:
        raise NotImplementedError(
            f"the fused_pd_step kernel has no prox for loss {loss!r} with "
            f"params {tuple(pkeys)}; it runs "
            + ", ".join(f"{k} {v[1]}" for k, v in _LOSSES.items()))
    kind = _LOSSES[name][0]
    if isinstance(reg, TotalVariation):
        reg_kind = 0
    elif isinstance(reg, SquaredTV):
        reg_kind = 1
    else:
        raise NotImplementedError(
            f"the fused_pd_step kernel has no dual resolvent for {reg!r}")
    bv, eb = int(block_nodes), int(block_edges)
    if src.ndim != 2 or src.shape[0] % eb:
        raise ValueError(f"src must be (nb*{eb}, 1), got {tuple(src.shape)}")
    nb = src.shape[0] // eb
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if iters != 1 and nb != 1:
        raise ValueError("multi-iteration fusion requires a single block")
    lanes = w_store.shape[0] if w_store.ndim == 3 else None
    lead = () if lanes is None else (lanes,)
    if lanes is not None and not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"fused_pd_step takes 1..{MAX_LANES} lanes, got "
                         f"{lanes}")
    n = w_store.shape[-1]
    if n < 1:
        raise ValueError(f"fused_pd_step needs at least one feature, got {n}")
    store = w_store.dtype
    if store not in _STORAGE:
        raise TypeError(f"fused_pd_step stores float32 or bfloat16, got "
                        f"{store}")
    device = w_store.device
    f32, i32 = torch.float32, torch.int32
    rows = (nb + kn - 1) * bv
    _check("w_store", w_store, lead + (rows, n), store, device)
    _check("u_store", u_store, lead + ((nb + klo + khi) * eb, n), store,
           device)
    params = tuple(params)
    shapes = _param_shapes(kind, rows, n, params)
    if len(params) != len(shapes):
        raise ValueError(f"{name} takes {len(shapes)} prox params, got "
                         f"{len(params)}")
    for key, t, shape in zip(pkeys, params, shapes):
        _check(f"params[{key!r}]", t, shape, store, device)
    num_samples = params[4].shape[1] if kind == 2 else 0
    _check("tau", tau, (rows, 1), f32, device)
    for label, t, dt in (("src", src, i32), ("dst", dst, i32),
                         ("sigma", sigma, f32)):
        _check(label, t, (nb * eb, 1), dt, device)
    _check("la", la, lead + (nb * eb, 1), f32, device)
    if (not isinstance(incidence, (tuple, list)) or len(incidence) != 3
            or any(t is None for t in incidence)):
        raise ValueError("fused_pd_step reads the compact incidence: pass "
                         "incidence=(in_ptr, in_ids, out_run), the "
                         "layout's EdgeBlockLayout.compact")
    in_ptr, in_ids, out_run = incidence
    _check("incidence in_ptr", in_ptr, (nb * bv + 1,), i32, device)
    _check("incidence out_run", out_run, (nb * bv, 2), i32, device)
    if in_ids.ndim != 1 or in_ids.shape[0] > nb * eb:
        raise ValueError(f"incidence in_ids must hold one id per in-edge "
                         f"slot, at most {nb * eb}; got "
                         f"{tuple(in_ids.shape)}")
    _check("incidence in_ids", in_ids, tuple(in_ids.shape), i32, device)
    if out is not None:
        _check_rows("out[0]", out[0], lead + (nb * bv, n), store, device)
        _check_rows("out[1]", out[1], lead + (nb * eb, n), store, device)
    if active is not None:
        if out is None:
            raise ValueError("active needs out: a stopped launch writes "
                             "nothing, so the outputs must be the state")
        _check("active", active, tuple(active.shape), torch.bool, device)
        if active.numel() != 1:
            raise ValueError(f"active must hold one flag, got "
                             f"{tuple(active.shape)}")
    if device.type != "cuda":
        raise ValueError(f"fused_pd_step launches on CUDA tensors; got "
                         f"{device} (kernels.ops.pd_step sends CPU tensors "
                         "to the plain version)")
    plan = plan_variant(kind, n, num_samples, lanes or 1)
    if streamed and plan == "staged":
        need, limit = streaming_bytes(kind, n, num_samples, lanes or 1)
        if need > limit:
            raise ValueError(f"{name} at n = {n} has no streamed variant "
                             "(its register-tile kernel always stages)")
        plan = "streamed"
    if plan is None:
        need, limit = streaming_bytes(kind, n, num_samples, lanes or 1)
        raise NotImplementedError(
            f"the fused_pd_step kernel needs {need} bytes of a block's "
            f"shared memory, at most {limit}, for {name} at n = {n}"
            + (f" with {num_samples} samples a node" if kind == 2 else "")
            + (f" over {lanes} lanes" if lanes else "")
            + (": the wide logistic variant keeps a node's Hessian, "
               "n (n + 1) / 2 floats, and four rows of n in one warp's "
               "shared memory" if kind == 2 and n > TILE_FEATURES else "")
            + " (the solver runs such a problem unfused)")

    if out is None:
        out = (torch.empty(lead + (nb * bv, n), dtype=store, device=device),
               torch.empty(lead + (nb * eb, n), dtype=store, device=device))
    w_new, u_new = out
    z = torch.empty(lead + (nb * bv, n), dtype=f32, device=device)
    res = torch.zeros((lanes or 1,), dtype=f32, device=device)
    if store == f32 or iters == 1:
        carry = (w_new, u_new)          # f32 carry lives in the outputs
    else:
        carry = (torch.empty(lead + (nb * bv, n), dtype=f32, device=device),
                 torch.empty(lead + (nb * eb, n), dtype=f32, device=device))

    # the register-tile streamed variant's scratch: the labeled nodes'
    # count, each iteration's work counter and their list
    work = None
    if plan == "streamed" and n <= TILE_FEATURES:
        work = torch.zeros(1 + iters + nb * bv, dtype=i32, device=device)

    def lane_stride(t):
        return t.stride(0) if lanes is not None else 0
    args = _PdArgs(
        w_store.data_ptr(), u_store.data_ptr(), in_ptr.data_ptr(),
        in_ids.data_ptr(), out_run.data_ptr(),
        (_P * 6)(*([t.data_ptr() for t in params]
                   + [None] * (6 - len(params)))),
        tau.data_ptr(), src.data_ptr(), dst.data_ptr(), sigma.data_ptr(),
        la.data_ptr(), w_new.data_ptr(), u_new.data_ptr(),
        carry[0].data_ptr(), carry[1].data_ptr(), z.data_ptr(),
        res.data_ptr(), None if active is None else active.data_ptr(),
        nb * bv, nb * eb, klo * eb, u_store.shape[-2], in_ids.shape[0],
        n, reg_kind, int(rho != 1.0), float(rho), int(iters),
        int(compute_residual), kind, _STORAGE[store], num_samples,
        int(getattr(loss, "num_inner", 0)),
        float(getattr(loss, "alpha", 0.0)), lanes or 1,
        *map(lane_stride, (w_store, u_store, w_new, u_new, *carry, la)),
        _build.execution_counter("fused_pd_step", device),
        int(plan == "streamed"), None if work is None else work.data_ptr())
    stream = torch.cuda.current_stream(device).cuda_stream
    with _prof.annotate(_prof.FUSED_STEP), torch.cuda.device(device):
        err = _build.entry("fused_pd_step_launch", _ARGTYPES)(
            ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"fused_pd_step launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        variant = variant_key(name, store, n, plan == "staged")
        fused_pd_step.launches += 1
        fused_pd_step.variant_launches[variant] += 1
        if (lanes or 1) > 1:
            fused_pd_step.lane_launches[variant] += 1
    if compute_residual:
        return w_new, u_new, res if lanes is not None else res[0]
    return w_new, u_new


fused_pd_step.launches = 0
fused_pd_step.variant_launches = collections.Counter()
fused_pd_step.lane_launches = collections.Counter()
