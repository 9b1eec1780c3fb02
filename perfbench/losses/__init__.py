"""The losses the benchmark knows, one module a loss, found by the
configuration's ``loss`` name.  A new loss arrives as one new file here.

Each module holds what the harness needs of its loss, and nothing of the
program:

* ``targets(x, w_true, gen)``: the targets of feature rows ``x``
  (..., m, n) under true weights ``w_true`` (..., n), drawn by ``gen``
  (``data.py``);
* ``drift(y, noise, gen)``: a serving request's redrawn targets ``y``
  with the traffic's noise (``data.Drift``);
* ``prox_flops(n, m, **loss_kwargs)`` and ``prox_floats(n, m)``: the
  float operations of one labeled node's primal update and the floats
  it reads (``work.py``);
* ``Prox(x, y, tau, **loss_kwargs)``: the plain reference's primal
  update of the labeled nodes, ``x`` (K, m, n), ``y`` (K, m) and
  ``tau`` (K, 1) in the reference's dtype, called on (..., K, n)
  (``ref/alg1.py``).

``loss_kwargs`` is the configuration's ``loss_kwargs``, the keywords the
program's loss takes too (the logistic loss's ``num_inner``).
"""
from __future__ import annotations

import importlib


def load(name: str):
    """The module of the loss ``name``."""
    module = f"perfbench.losses.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"no loss {name!r} in perfbench/losses/") from None
