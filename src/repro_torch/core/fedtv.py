"""FedTV: networked-federated personalization of model training.

This is the integration of the paper's technique (nLasso TV-coupling,
Algorithm 1) with gradient-based training of an arbitrary backbone model.
Semantics:

  * the global batch is partitioned into C *clients* (contiguous groups
    of examples, so each client's examples stay together);
  * each client owns a personalized parameter block: a multiplicative
    gain delta_c in R^{d_model} applied to the final hidden states —
    the deep-net analogue of the paper's per-node linear weights w^(i);
  * clients are related by an empirical graph (physical topology,
    cohort similarity, ...); the TV penalty lambda * sum_e A_e
    ||delta_i - delta_j||_1 couples neighbouring clients exactly as
    eq. (3) couples local models;
  * the update interleaves one SGD step on the backbone with one
    primal-dual step (eqs. 14-15) on (delta, u).  The primal prox is
    approximated by a single gradient step — the paper explicitly notes
    (§4) the iterations are robust to inexact resolvent evaluation.

The client graph is tiny (C ~ 16-32 nodes), so the nLasso state adds only
(C + E) * d_model floats; the TV update is O(E d) — negligible next to the
backbone step, but it changes *what* is learned: clients in the same
cluster share statistical strength, heterogeneous clients keep their own
gains.  The state lives on the device ``init_state`` is given (``None``
= the CUDA card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.backends import pd_iteration
from repro_torch.api.regularizers import TotalVariation
from repro_torch.core.graph import EmpiricalGraph, chain_graph, sbm_graph
from repro_torch.device import resolve_device

_TV = TotalVariation()


@dataclasses.dataclass(frozen=True)
class FedTVConfig:
    num_clients: int = 16
    lam: float = 1e-3            # TV strength (paper's lambda)
    prox_lr: float = 0.1         # inner gradient step approximating PU_i
    graph_kind: str = "clusters"  # clusters | chain
    num_clusters: int = 2
    p_in: float = 0.8
    p_out: float = 0.05
    seed: int = 0


def make_client_graph(cfg: FedTVConfig, device=None) -> EmpiricalGraph:
    """The client graph from ``cfg.seed``'s numpy generator, on ``device``
    (``None`` = the CUDA card)."""
    rng = np.random.default_rng(cfg.seed)
    if cfg.graph_kind == "chain":
        return chain_graph(rng, cfg.num_clients, device=device)
    sizes = [cfg.num_clients // cfg.num_clusters] * cfg.num_clusters
    sizes[-1] += cfg.num_clients - sum(sizes)
    g, _ = sbm_graph(rng, sizes, cfg.p_in, cfg.p_out, device=device)
    return g


def init_state(cfg: FedTVConfig, d_model: int, device=None) -> dict:
    """Returns the FedTV state carried by the train step, on ``device``."""
    dev = resolve_device(device)
    g = make_client_graph(cfg, device=dev)
    return {
        "delta": torch.zeros((cfg.num_clients, d_model), dtype=torch.float32,
                             device=dev),
        "dual": torch.zeros((g.num_edges, d_model), dtype=torch.float32,
                            device=dev),
        "graph": g,
    }


def client_ids(global_batch: int, num_clients: int,
               device=None) -> torch.Tensor:
    """Deterministic example->client map: contiguous groups."""
    dev = resolve_device(device)
    return (torch.arange(global_batch, device=dev) * num_clients
            ) // global_batch


def apply_gain(hidden: torch.Tensor, delta: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """hidden (B, T, d) -> personalized hidden via h * (1 + delta_c)."""
    gain = 1.0 + delta[ids]                      # (B, d)
    return hidden * gain[:, None, :].to(hidden.dtype)


def pd_update(state: dict, grad_delta: torch.Tensor,
              cfg: FedTVConfig) -> dict:
    """One primal-dual step of Algorithm 1 on the personalization block.

    primal (eq. 17, inexact prox):
        delta <- delta - tau_c (prox_lr * grad_delta + (D^T u)_c)
    dual (step 10):
        u <- clip_{lam A_e}(u + sigma D (2 delta+ - delta))

    Thin adapter over the port's ``pd_iteration`` — the primal update is
    expressed as the inexact (one-gradient-step) prox the paper allows,
    the dual update is the TV regularizer's resolvent.
    """
    g: EmpiricalGraph = state["graph"]
    delta, u = state["delta"], state["dual"]
    tau = g.primal_stepsizes()

    def grad_step_prox(v):
        # single gradient step approximating PU_i (paper §4 remark on
        # robustness to inexact resolvent evaluation)
        return v - tau[:, None] * (cfg.prox_lr * grad_delta)

    delta_new, u_new = pd_iteration(g, grad_step_prox, _TV, cfg.lam, tau,
                                    g.dual_stepsizes(), delta, u)
    return {"delta": delta_new, "dual": u_new, "graph": g}


def tv_value(state: dict) -> torch.Tensor:
    """Current TV of the personalization block (monitoring metric)."""
    return state["graph"].total_variation(state["delta"])
