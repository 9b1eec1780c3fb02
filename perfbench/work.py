"""The work one iteration of Algorithm 1 needs, counted from the
problem's shapes, and the least time an NVIDIA H100 could take for it.

Counted once an iteration, whatever implements the step:

* read: the state w (V x n) and u (E x n) of every lane, the graph as
  one int32 pair an edge plus its float32 weight A_e, the primal
  stepsize tau_i (a float32 a node), and the primal update's inputs of
  each *labeled* node (an unlabeled node's update is the identity and
  reads nothing): the squared loss's affine map (P_i, b_i), n x n + n
  floats, or the logistic loss's m_i samples and labels, m_i (n + 1)
  floats;
* written: the new state of every lane;
* float operations: D^T u (2 E n), the primal step (2 V n), each
  labeled node's update (the squared loss: (2 n + 1) n; the logistic
  loss: ``num_inner`` Newton steps over m samples and an n x n
  Cholesky solve), D (2 w+ - w) (2 V n + E n), the dual step and clip
  (4 E n), the relaxation and its re-projection (3 V n + 5 E n) and the
  residual (3 V n + 3 E n).

The lanes of a lambda path share the graph, tau and the primal update's
inputs, so those count once a launch; state, outputs and operations
count once a lane.

It departs from ``chip_smoke.py:step_cost``, which counts the tables the
kernel itself reads (its compact incidence, the padded prox parameters,
sigma and lam A_e per edge): those move whenever the layout changes, and
a roofline must read the same work whatever implements it.
"""
from __future__ import annotations

from perfbench import losses

#: Published peaks of one NVIDIA H100 SXM (data sheet, dense, no
#: sparsity): HBM3 bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float64": 8}


def prox_flops(loss: str, n: int, m: int, **loss_kwargs) -> int:
    """Float operations of one labeled node's primal update (the loss's
    module in ``perfbench/losses/``)."""
    return losses.load(loss).prox_flops(n, m, **loss_kwargs)


def prox_floats(loss: str, n: int, m: int) -> int:
    """Floats one labeled node's primal update reads."""
    return losses.load(loss).prox_floats(n, m)


def step_work(*, nodes: int, edges: int, n: int, m: int, labeled: int,
              loss: str, lanes: int = 1, dtype: str = "float32",
              loss_kwargs: dict | None = None) -> dict:
    """Bytes and float operations of one iteration of ``lanes`` lanes."""
    s = _ITEMSIZE[dtype]
    state = (nodes + edges) * n * s
    shared = edges * (8 + 4) + nodes * 4 + labeled * prox_floats(
        loss, n, m) * 4
    read = lanes * state + shared
    written = lanes * state
    flops = lanes * (2 * edges * n                   # D^T u
                     + 2 * nodes * n                 # w - tau D^T u
                     + labeled * prox_flops(loss, n, m,
                                            **(loss_kwargs or {}))
                     + 2 * nodes * n + edges * n     # D (2 w+ - w)
                     + 4 * edges * n                 # dual step, clip
                     + 3 * nodes * n + 5 * edges * n  # relaxation
                     + 3 * nodes * n + 3 * edges * n)  # residual
    return {"bytes_read": read, "bytes_written": written, "flops": flops}


def least_seconds(work: dict) -> float:
    """The least time the H100 could take: bytes over the memory rate
    against operations over the float32 rate, whichever is longer."""
    t_bytes = (work["bytes_read"] + work["bytes_written"]) / HBM_BYTES_PER_S
    t_ops = work["flops"] / F32_FLOPS_PER_S
    return max(t_bytes, t_ops)

