"""Build and load the port's CUDA kernels: one shared library for all.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` — one
``nvcc -c`` per source, all started together — and the objects are
linked into one shared library with plain C entry points under
``build/repro_torch_kernels/`` at the repository root.  The library is
named by a hash of every source, every ``csrc/*.cuh`` header and the
flags, so an edited source or header rebuilds.  It is loaded with
``ctypes``; each kernel wrapper binds its own entry point through
:func:`entry`.  Nothing is built or loaded at import: this runs on the
first launch, on a machine with the CUDA toolkit.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-shared",)

_LIB: ctypes.CDLL | None = None
_ENTRIES: dict[str, ctypes._CFuncPtr] = {}


def sources() -> list[Path]:
    """The kernel sources the library is built from."""
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[Path, dict[str, str]]:
    """Compile and link the library if it is not built yet.

    Returns ``(library path, compiler output per source file)``;
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills
    per kernel) and forces a rebuild so the output is there to read.
    """
    lib = library_path()
    if lib.exists() and not verbose:
        return lib, {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    logs: dict[str, str] = {}
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / f"{src.stem}.o"
            objs.append(str(obj))
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, proc in procs:
            out, err = proc.communicate()
            logs[name] = out + err
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp_lib = Path(tmp) / "lib.so"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, *LINK_FLAGS, "-o", str(tmp_lib), *objs],
            capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp_lib, lib)
    return lib, logs


def library() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    global _LIB
    if _LIB is None:
        path, _ = build()
        _LIB = ctypes.CDLL(str(path))
    return _LIB


def entry(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` (returns a CUDA error code as int),
    with its argument types declared once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


#: per (kernel, device): the device int64 that the kernel's block 0 adds
#: one to each time the kernel runs, launched or replayed from a CUDA graph
_EXECUTIONS: dict[tuple[str, torch.device], torch.Tensor] = {}


def execution_counter(kernel: str, device: torch.device) -> int | None:
    """The device address of ``kernel``'s execution count on ``device``,
    made (zeroed) on first use; None inside a capture that would have to
    make it (the kernel then counts nothing).  The wrappers pass it to
    every launch."""
    count = _EXECUTIONS.get((kernel, device))
    if count is None:
        if torch.cuda.is_current_stream_capturing():
            return None
        count = _EXECUTIONS[(kernel, device)] = torch.zeros(
            1, dtype=torch.int64, device=device)
    return count.data_ptr()


def executions(kernel: str) -> int:
    """How many times ``kernel`` ran on the card, on every device, since
    :func:`reset_executions`: the launches and the kernels that replays
    of a captured graph ran (a wrapper's ``launches`` counts only the
    former).  Reads the device counts on the host, so it waits for the
    card: for measurement, never on a solve's path."""
    return sum(int(c.item()) for (k, _), c in _EXECUTIONS.items()
               if k == kernel)


def reset_executions() -> None:
    """Zero every execution count (on its device's current stream)."""
    for count in _EXECUTIONS.values():
        count.zero_()


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel takes through a raw pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
