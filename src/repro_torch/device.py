"""The port's one device rule, and the way its host code reads a tensor.

Every entry point of :mod:`repro_torch` takes ``device=None``, and
``None`` means the CUDA card: the port exists to run on an NVIDIA GPU,
so a missing card is an error, never a quiet move to the CPU.  Callers
that want the CPU (the tests) ask for it with ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; anything else as given, a
    CUDA device without an index as the current one (so that it equals
    the device of the tensors on it).

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_host(a) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array: the
    host-side planners and the serving layer's host events read
    tensors this way."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
