"""The concrete scenario zoo — eight registered workloads (the
reference's ``repro.scenarios.zoo``).

Each scenario pins one point of the (graph family x data model x loss x
regularizer) space the paper's template covers:

  * ``sbm_regression``      — the paper's §5 reference setup,
  * ``chain_changepoint``   — fused-lasso changepoint recovery on a path
                              (Localized Linear Regression in Networked
                              Data, arXiv 1903.11178),
  * ``grid2d``              — TV denoising of a piecewise-constant signal
                              on a 2-D lattice,
  * ``small_world``         — Watts-Strogatz ring with heterogeneous
                              per-node label noise,
  * ``pref_attach``         — Barabasi-Albert hub-dominated degrees (the
                              adversarial case for degree-preconditioned
                              steps),
  * ``clustered_logistic``  — clustered federated classification via
                              GTVMin (arXiv 2105.12769) with the §4.3
                              logistic loss,
  * ``sparse_lasso``        — the §4.2 high-dimensional regime
                              (m_i < n): sparse per-cluster weights, the
                              Lasso local loss with its ISTA prox,
  * ``laplacian_smoothing`` — GTVMin quadratic coupling (``tv2``):
                              a smoothly varying weight field on a ring,
                              Laplacian-style smoothing instead of
                              piecewise-constant clustering.

Every builder takes ``(rng, smoke)`` and returns a
:class:`~repro_torch.data.synthetic.NetworkedDataset` on the CPU (the
reference's builders, draw for draw; ``Scenario.build`` moves the
instance to its device); ``smoke=True`` shrinks the instance to CI size
without changing its character.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import (barabasi_albert_graph, chain_graph,
                                    grid_graph, sbm_graph,
                                    watts_strogatz_graph)
from repro_torch.data.synthetic import (NetworkedDataset,
                                        make_classification_data,
                                        make_regression_data)
from repro_torch.scenarios.base import register_scenario


@register_scenario(
    "sbm_regression",
    description="Paper §5: two-cluster SBM, noiseless linear labels, "
                "30 labeled nodes.",
    graph_family="sbm", data_model="clustered linear regression",
    lam=1e-3, lam_path=(1e-4, 1e-3, 1e-2), metric="mse")
def sbm_regression(rng: np.random.Generator,
                   smoke: bool) -> NetworkedDataset:
    sizes, labeled = ((40, 40), 16) if smoke else ((150, 150), 30)
    graph, assign = sbm_graph(rng, sizes, p_in=0.5, p_out=1e-3,
                              device="cpu")
    w_true = np.array([[2.0, 2.0], [-2.0, 2.0]], np.float32)[assign]
    return make_regression_data(rng, graph, w_true, samples_per_node=5,
                                num_labeled=labeled, clusters=assign)


@register_scenario(
    "chain_changepoint",
    description="1903.11178-style fused lasso: piecewise-constant weights "
                "along a path graph with 4 changepoints.",
    graph_family="chain", data_model="piecewise-constant regression",
    lam=5e-2, lam_path=(5e-3, 2e-2, 5e-2, 2e-1), metric="mse")
def chain_changepoint(rng: np.random.Generator,
                      smoke: bool) -> NetworkedDataset:
    V = 60 if smoke else 200
    graph = chain_graph(rng, V, device="cpu")
    # 5 equal segments, per-segment weight vectors well separated
    seg = np.minimum(np.arange(V) * 5 // V, 4)
    levels = np.array([[2.0, -1.0], [-1.5, 1.0], [0.5, 2.0],
                       [-2.0, -0.5], [1.0, 1.5]], np.float32)
    return make_regression_data(rng, graph, levels[seg], samples_per_node=5,
                                num_labeled=max(V // 4, 4), noise_scale=0.1,
                                clusters=seg)


@register_scenario(
    "grid2d",
    description="TV denoising on a 2-D lattice: weights constant per "
                "quadrant, 4-neighbour coupling.",
    graph_family="grid", data_model="piecewise-constant regression",
    lam=5e-2, lam_path=(5e-3, 2e-2, 5e-2, 2e-1), metric="mse")
def grid2d(rng: np.random.Generator, smoke: bool) -> NetworkedDataset:
    side = 8 if smoke else 20
    graph = grid_graph(rng, side, side, device="cpu")
    rr, cc = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    quad = ((rr >= side // 2).astype(np.int64) * 2
            + (cc >= side // 2)).ravel()
    levels = np.array([[2.0, 0.0], [0.0, 2.0], [-2.0, 0.0], [0.0, -2.0]],
                      np.float32)
    return make_regression_data(rng, graph, levels[quad], samples_per_node=5,
                                num_labeled=max(side * side // 5, 4),
                                noise_scale=0.1, clusters=quad)


@register_scenario(
    "small_world",
    description="Watts-Strogatz ring (k=4, p=0.1): two arc clusters, "
                "heterogeneous per-node label noise.",
    graph_family="watts_strogatz", data_model="heteroscedastic regression",
    lam=2e-2, lam_path=(2e-3, 1e-2, 2e-2, 1e-1), metric="mse")
def small_world(rng: np.random.Generator, smoke: bool) -> NetworkedDataset:
    V = 50 if smoke else 150
    graph = watts_strogatz_graph(rng, V, k=4, p_rewire=0.1,
                                 device="cpu")
    arc = (np.arange(V) >= V // 2).astype(np.int64)
    levels = np.array([[1.5, -1.5], [-1.5, 1.5]], np.float32)
    # heterogeneous channels: per-node noise spans an order of magnitude
    noise = 10.0 ** rng.uniform(-1.5, -0.5, size=V).astype(np.float32)
    return make_regression_data(rng, graph, levels[arc], samples_per_node=5,
                                num_labeled=max(V // 4, 4),
                                noise_scale=noise, clusters=arc)


@register_scenario(
    "pref_attach",
    description="Barabasi-Albert (m=2) hub-dominated graph: stress case "
                "for the degree preconditioner, generation-based clusters.",
    graph_family="barabasi_albert", data_model="clustered linear regression",
    lam=1e-2, lam_path=(1e-3, 5e-3, 1e-2, 5e-2), metric="mse")
def pref_attach(rng: np.random.Generator, smoke: bool) -> NetworkedDataset:
    V = 50 if smoke else 150
    graph = barabasi_albert_graph(rng, V, m=2, device="cpu")
    # early (hub) generation vs late arrivals
    gen = (np.arange(V) >= V // 2).astype(np.int64)
    levels = np.array([[2.0, 1.0], [-1.0, -2.0]], np.float32)
    return make_regression_data(rng, graph, levels[gen], samples_per_node=5,
                                num_labeled=max(V // 4, 4), noise_scale=0.1,
                                clusters=gen)


@register_scenario(
    "sparse_lasso",
    description="Paper §4.2 high-dim regime: m_i < n local samples, "
                "sparse per-cluster weights, Lasso local loss (ISTA prox).",
    graph_family="sbm", data_model="sparse high-dim regression",
    loss="lasso", loss_kwargs={"alpha": 0.02, "num_inner": 30},
    lam=1e-2, lam_path=(1e-3, 5e-3, 1e-2, 5e-2), metric="mse")
def sparse_lasso(rng: np.random.Generator, smoke: bool) -> NetworkedDataset:
    sizes, labeled = ((20, 20), 10) if smoke else ((60, 60), 24)
    graph, assign = sbm_graph(rng, sizes, p_in=0.5, p_out=1e-3,
                              device="cpu")
    # sparse 4-dim weights, 3 samples per node: each node alone is
    # under-determined, the TV coupling + l1 prox recover the support
    levels = np.array([[2.0, 0.0, -1.5, 0.0],
                       [0.0, -2.0, 0.0, 1.5]], np.float32)
    return make_regression_data(rng, graph, levels[assign],
                                samples_per_node=3, num_labeled=labeled,
                                noise_scale=0.05, clusters=assign)


@register_scenario(
    "laplacian_smoothing",
    description="GTVMin quadratic coupling (tv2): smoothly varying "
                "weight field on a ring, squared loss.",
    graph_family="watts_strogatz", data_model="smooth field regression",
    regularizer="tv2", lam=5e-2, lam_path=(5e-3, 2e-2, 5e-2, 2e-1),
    metric="mse")
def laplacian_smoothing(rng: np.random.Generator,
                        smoke: bool) -> NetworkedDataset:
    V = 40 if smoke else 120
    graph = watts_strogatz_graph(rng, V, k=4, p_rewire=0.05,
                                 device="cpu")
    # a smooth (single-harmonic) field over the ring: the regime where
    # quadratic coupling beats the piecewise-constant TV prior
    t = 2.0 * np.pi * np.arange(V) / V
    w_true = np.stack([1.5 * np.sin(t), 1.5 * np.cos(t)],
                      axis=1).astype(np.float32)
    return make_regression_data(rng, graph, w_true, samples_per_node=5,
                                num_labeled=max(V // 4, 4),
                                noise_scale=0.1)


@register_scenario(
    "clustered_logistic",
    description="2105.12769-style clustered federated classification: SBM "
                "graph, Bernoulli labels, §4.3 logistic loss.",
    graph_family="sbm", data_model="clustered logistic classification",
    loss="logistic", lam=2e-3, lam_path=(2e-4, 1e-3, 2e-3, 1e-2),
    metric="accuracy")
def clustered_logistic(rng: np.random.Generator,
                       smoke: bool) -> NetworkedDataset:
    sizes, labeled = ((24, 24), 12) if smoke else ((60, 60), 24)
    graph, assign = sbm_graph(rng, sizes, p_in=0.5, p_out=1e-3,
                              device="cpu")
    w_true = np.array([[3.0, 3.0], [-3.0, 3.0]], np.float32)[assign]
    return make_classification_data(rng, graph, w_true, samples_per_node=8,
                                    num_labeled=labeled, clusters=assign)
