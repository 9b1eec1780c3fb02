"""The mesh the sharded backends run over: ranks of a process group.

The reference's sharded backends are single-controller: one host drives
a ``jax.sharding.Mesh`` of devices through ``shard_map``.  The port is
SPMD instead: each shard is a *rank* of a ``torch.distributed`` process
group.  Every rank calls ``Solver.run`` with the whole problem, plans the
same partition (the numpy planners are deterministic), keeps its own
shard, exchanges halos through the group's collectives each iteration,
and all-gathers the owned rows of ``w`` and ``u`` at the end, so every
rank returns the same result — what the reference's host returns.

:func:`make_host_mesh` is the counterpart of
``repro.core.mesh.make_host_mesh``.  Its :class:`Mesh` has the
reference's ``shape`` mapping (``mesh.shape["data"]``), and besides it
the rank, the process group, the device the rank's tensors live on and
the transport that moves them:

  * one rank and no group: every collective is the identity (what
    ``SolverConfig(mesh=None)`` resolves to);
  * ``gloo``: ranks that share a device (NCCL refuses two ranks on one
    GPU) or live on the CPU.  Gloo's collectives here take host tensors,
    so a rank on the card copies each exchanged buffer to the host and
    back explicitly (``via_host``); its kernels still run on the card;
  * ``nccl``: one CUDA device a rank.

The caller (or its launcher) initializes the process group and so picks
the transport; the mesh only reads it and never switches it.  The port's
mesh spans one axis of ranks, ``data``: ``model`` is 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device

_OPS = ("sum", "max")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) mesh of ranks; see the module docstring.

    ``shape`` maps each axis name to its size, ``rank`` is this process's
    index along ``data``, ``group`` the ``torch.distributed`` process
    group (None for one rank), ``device`` where this rank's tensors
    live, and ``transport`` the group's backend (``"gloo"`` /
    ``"nccl"``; None without a group)."""

    shape: dict
    rank: int
    group: Any
    device: torch.device
    transport: str | None

    @property
    def via_host(self) -> bool:
        """Whether exchanged buffers cross through host memory (gloo
        with the rank's tensors on the card)."""
        return self.transport == "gloo" and self.device.type == "cuda"

    def _identity(self, axis: str) -> bool:
        if axis not in self.shape:
            raise KeyError(f"mesh has axes {tuple(self.shape)}, not "
                           f"{axis!r}")
        return axis != "data" or self.group is None

    def _from_wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.via_host else t

    def all_gather(self, t: torch.Tensor, axis: str = "data"
                   ) -> torch.Tensor:
        """Every rank's (rows, ...) ``t`` stacked in rank order:
        (size * rows, ...), the same on every rank (``jax.lax.all_gather``
        with ``tiled=True``)."""
        if self._identity(axis):
            return t
        import torch.distributed as dist

        size = self.shape[axis]
        src = (t.to("cpu") if self.via_host else t).contiguous()
        rows = src.shape[0]
        out = src.new_empty((size * rows,) + tuple(src.shape[1:]))
        dist.all_gather([out[r * rows:(r + 1) * rows] for r in range(size)],
                        src, group=self.group)
        return self._from_wire(out)

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   axis: str = "data") -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") of every rank's ``t``,
        as a new tensor (``t`` itself on a one-rank axis)."""
        if op not in _OPS:
            raise ValueError(f"all_reduce op must be one of {_OPS}, got "
                             f"{op!r}")
        if self._identity(axis):
            return t
        import torch.distributed as dist

        buf = t.to("cpu" if self.via_host else t.device,
                   copy=True).contiguous()
        dist.all_reduce(buf, op=(dist.ReduceOp.SUM if op == "sum"
                                 else dist.ReduceOp.MAX), group=self.group)
        return self._from_wire(buf)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None,
                   group=None) -> Mesh:
    """A mesh of ``data`` ranks (counterpart of the reference's
    ``make_host_mesh``).

    ``device`` is where this rank's tensors live (``None`` = the current
    CUDA device, as every entry point of the port).  With ``data == 1``
    and no ``group`` the mesh needs no process group.  Otherwise
    ``group`` (default: the world) must be an initialized
    ``torch.distributed`` group of exactly ``data`` ranks over gloo or
    NCCL; NCCL needs the rank's device to be a CUDA one.  Raises where
    these do not hold.
    """
    if model != 1:
        raise NotImplementedError(
            "the port's mesh spans one axis of ranks ('data'); model must "
            f"be 1, got {model}")
    data = int(data)
    if data < 1:
        raise ValueError(f"a mesh needs at least one rank, got data={data}")
    dev = resolve_device(device)
    shape = {"data": data, "model": 1}
    if data == 1 and group is None:
        return Mesh(shape=shape, rank=0, group=None, device=dev,
                    transport=None)
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a mesh of {data} ranks needs an initialized torch.distributed "
            f"process group of {data} ranks (torch.distributed."
            "init_process_group with backend 'gloo' or 'nccl')")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if size != data:
        raise ValueError(f"a mesh of {data} ranks needs a process group of "
                         f"{data} ranks; this one has {size}")
    transport = str(dist.get_backend(group))
    if transport not in ("gloo", "nccl"):
        raise ValueError(f"the mesh moves tensors over gloo or nccl, not "
                         f"{transport!r}")
    if transport == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL moves CUDA tensors; this rank's device is "
                         f"{dev}")
    return Mesh(shape=shape, rank=dist.get_rank(group), group=group,
                device=dev, transport=transport)
