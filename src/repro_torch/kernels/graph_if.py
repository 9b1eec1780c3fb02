"""A captured CUDA graph under an IF node on a device flag.

The tol engines (``engine.loop.device_loop``) capture one metric block
with PyTorch's stream capture and wrap it here: ``csrc/graph_cond.cu``
builds a graph of a one-thread kernel that reads the flag and an IF node
whose body is the block, so each :meth:`IfGraph.replay` runs the block
while the flag is set and nothing after it clears.  PyTorch 2.11 has no
Python hook for conditional nodes, hence the small source of its own.
Built with the port's kernels (``kernels/_build.py``) on first use.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p


class IfGraph:
    """``flag -> IF { body }`` over a captured ``torch.cuda.CUDAGraph``
    (made with ``keep_graph=True`` and not instantiated).  Holds the
    capture, so the memory its body addresses stays reserved, and the
    flag tensor it reads."""

    def __init__(self, body: "torch.cuda.CUDAGraph", flag: torch.Tensor):
        if flag.dtype != torch.bool or flag.numel() != 1:
            raise ValueError("the IF node reads a one-element bool flag")
        self._body, self._flag, self.device = body, flag, flag.device
        exec_, graph = _P(), _P()
        err = _build.entry("repro_if_graph_create",
                           [_P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P)])(
            body.raw_cuda_graph(), flag.data_ptr(), ctypes.byref(exec_),
            ctypes.byref(graph))
        if err != 0:
            raise RuntimeError(f"building the IF graph failed: CUDA error "
                               f"{err}")
        self._exec, self._graph = exec_, graph

    def replay(self) -> None:
        """Launch on the current stream: the body runs if the flag is set
        when the launch reaches it."""
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = _build.entry("repro_if_graph_launch", [_P, _P])(self._exec,
                                                              stream)
        if err != 0:
            raise RuntimeError(f"IF graph launch failed: CUDA error {err}")

    def close(self) -> None:
        """Free the executable (launches in flight complete first)."""
        if self._exec is not None:
            _build.entry("repro_if_graph_destroy", [_P, _P])(self._exec,
                                                             self._graph)
            self._exec = self._graph = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
