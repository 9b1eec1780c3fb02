"""Build the port's objects from numpy arrays.

State and inputs cross from the reference package (or anywhere else) as
plain numpy arrays: a caller turns its objects into numpy
(``np.asarray``) and hands the arrays in by field name.  This module
never sees an array of another framework.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.problem import Problem
from repro_torch.core.graph import (EdgeBlockLayout, EmpiricalGraph,
                                    compact_incidence)
from repro_torch.core.losses import NodeData
from repro_torch.device import resolve_device

_INT_FIELDS = ("src", "dst", "inc_edges", "node_perm", "node_inv",
               "edge_pos", "in_ptr", "in_ids", "out_run")
_COMPACT_FIELDS = ("in_ptr", "in_ids", "out_run")


def _tensor(name: str, a, dev: torch.device) -> torch.Tensor:
    dtype = np.int32 if name in _INT_FIELDS else np.float32
    return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)


def graph_from_arrays(src, dst, weights, inc_edges, inc_signs,
                      num_nodes: int, device=None) -> EmpiricalGraph:
    """An :class:`EmpiricalGraph` from its five arrays (already
    canonical, as ``build_graph`` leaves them)."""
    dev = resolve_device(device)
    arrays = dict(src=src, dst=dst, weights=weights, inc_edges=inc_edges,
                  inc_signs=inc_signs)
    return EmpiricalGraph(**{k: _tensor(k, v, dev)
                             for k, v in arrays.items()},
                          num_nodes=int(num_nodes))


def node_data_from_arrays(x, y, sample_mask, labeled_mask,
                          device=None) -> NodeData:
    """A :class:`NodeData` from its four arrays."""
    dev = resolve_device(device)
    return NodeData(*(_tensor("", a, dev)
                      for a in (x, y, sample_mask, labeled_mask)))


def layout_from_arrays(fields: dict, device=None) -> EdgeBlockLayout:
    """An :class:`EdgeBlockLayout` from a dict of every field by name
    (the int extents and the arrays).  The compact incidence, a field of
    the port only, is built from the padded tables where the dict lacks
    it (a reference layout)."""
    dev = resolve_device(device)
    if any(k not in fields for k in _COMPACT_FIELDS):
        compact = compact_incidence(np.asarray(fields["inc_edges"]),
                                    np.asarray(fields["inc_signs"]))
        fields = dict(fields, **dict(zip(_COMPACT_FIELDS, compact)))
    kw = {}
    for f in dataclasses.fields(EdgeBlockLayout):
        v = fields[f.name]
        kw[f.name] = (int(v) if f.type in ("int", int)
                      else _tensor(f.name, v, dev))
    return EdgeBlockLayout(**kw)


def problem_from_arrays(graph: dict, data: dict, lam: float = 1e-3, *,
                        loss="squared", regularizer="tv", device=None,
                        **loss_kwargs) -> Problem:
    """A :class:`Problem` from the graph's and the data's arrays by field
    name (``graph`` as :func:`graph_from_arrays` takes them, ``data`` as
    :func:`node_data_from_arrays`); ``loss_kwargs`` configure a loss
    given by name (e.g. ``alpha`` and ``num_inner`` of the lasso)."""
    dev = resolve_device(device)
    return Problem.create(graph_from_arrays(**graph, device=dev),
                          node_data_from_arrays(**data, device=dev), lam,
                          loss=loss, regularizer=regularizer, device=dev,
                          **loss_kwargs)


def state_from_arrays(w, u, device=None) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Solver state ``(w (V, n), u (E, n))`` as float32 tensors, e.g. a
    warm start carried over from another solve."""
    dev = resolve_device(device)
    return _tensor("w", w, dev), _tensor("u", u, dev)
