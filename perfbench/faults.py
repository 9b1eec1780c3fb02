"""Faults planted under the timed path, for the checks that ``correct``
must fail (``control.py`` on the card, ``tests/`` on the CPU).

* ``frozen``: every launch of the fused step returns its state unchanged
  (and a zero residual, so a tol solve stops at its first block);
* ``altered``: each fused solve's answer altered where it is produced,
  one node's weights moved by 5% of the largest weight;
* ``half_delta``: a service update applies the first half of its
  nodes' new rows and leaves the rest out;
* ``half_lanes``: a lambda path returns its second half of lanes
  unsolved (zeros).

The control itself is no fault: it is the program with its own
bfloat16 storage path switched on (``--dtype bfloat16`` in
``control.py``).
"""
from __future__ import annotations

import contextlib

FAULTS = ("frozen", "altered", "half_delta", "half_lanes")


@contextlib.contextmanager
def applied(fault: str | None):
    """Plant ``fault`` for the block (none for ``None``)."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    patches = {"frozen": _frozen, "altered": _altered,
               "half_delta": _half_delta, "half_lanes": _half_lanes}[fault]()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _frozen():
    import torch
    from repro_torch.kernels import ops

    def pd_step(w_store, u_store, *args, out=None, compute_residual=False,
                **kw):
        lead = w_store.shape[:-2]
        res = torch.zeros(lead, dtype=torch.float32, device=w_store.device)
        return (out[0], out[1], res) if compute_residual else out
    return [(ops, "pd_step", pd_step)]


def _altered():
    import dataclasses

    from repro_torch.api import backends
    real = backends._solve_fused

    def solve_fused(*args, **kw):
        r = real(*args, **kw)
        w = r.w.clone()
        w[..., 0, 0] += 0.05 * w.abs().max()
        return dataclasses.replace(r, w=w)
    return [(backends, "_solve_fused", solve_fused)]


def _half_delta():
    import dataclasses

    from repro_torch.serving import service
    real = service._apply_delta

    def apply_delta(data, delta):
        half = len(delta.nodes) // 2
        return real(data, dataclasses.replace(
            delta, nodes=delta.nodes[:half], y=delta.y[:half]))
    return [(service, "_apply_delta", apply_delta)]


def _half_lanes():
    import dataclasses

    from repro_torch.api import backends
    real = backends._solve_fused

    def solve_fused(*args, lams=None, **kw):
        r = real(*args, lams=lams, **kw)
        if lams is None:
            return r
        w = r.w.clone()
        w[len(lams) // 2:] = 0.0
        return dataclasses.replace(r, w=w)
    return [(backends, "_solve_fused", solve_fused)]
