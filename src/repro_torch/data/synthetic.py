"""Synthetic networked data: the paper's §5 SBM setup + generic builders.

The §5 reference instance: SBM empirical graph with two clusters
|C1| = |C2| = 150, p_in = 1/2; each node holds m_i = 5 data points with
features x ~ N(0, I_2) and noiseless labels y = x^T wbar^(i),
wbar = (2,2) in C1 and (-2,2) in C2.  A training set M of 30
randomly-selected nodes is labeled.  :func:`make_regression_data` and
:func:`make_classification_data` attach local datasets to any graph (the
scenario zoo, ``repro_torch.scenarios``, builds on them).

All randomness is numpy, drawn in the reference's order, so both
packages build bit-identical datasets from one seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import EmpiricalGraph, sbm_graph
from repro_torch.core.losses import NodeData
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class NetworkedDataset:
    graph: EmpiricalGraph
    data: NodeData
    w_true: torch.Tensor         # (V, n) ground-truth weights
    clusters: np.ndarray         # (V,) cluster assignment
    labeled_nodes: np.ndarray    # (M,) indices of the training set M


def _labeled_mask(rng: np.random.Generator, num_nodes: int,
                  num_labeled: int) -> tuple[np.ndarray, np.ndarray]:
    labeled = rng.choice(num_nodes, size=num_labeled, replace=False)
    mask = np.zeros(num_nodes, dtype=np.float32)
    mask[labeled] = 1.0
    return labeled, mask


def make_regression_data(
    rng: np.random.Generator,
    graph: EmpiricalGraph,
    w_true: np.ndarray,
    samples_per_node: int = 5,
    num_labeled: int = 30,
    noise_scale: float | np.ndarray = 0.0,
    clusters: np.ndarray | None = None,
) -> NetworkedDataset:
    """Local linear-regression datasets on an arbitrary empirical graph.

    y^(i) = x^T wbar^(i) + noise_scale_i * eps with x ~ N(0, I_n).
    ``noise_scale`` may be a scalar or a (V,) array of per-node scales.
    The tensors go to the graph's device.
    """
    V = graph.num_nodes
    dev = graph.device
    w_true = np.asarray(w_true, dtype=np.float32)
    n = w_true.shape[1]
    scale = np.broadcast_to(np.asarray(noise_scale, np.float32), (V,))
    x = rng.standard_normal((V, samples_per_node, n)).astype(np.float32)
    y = np.einsum("vmn,vn->vm", x, w_true)
    if np.any(scale > 0):      # noiseless callers draw nothing from rng here
        y = y + scale[:, None] * rng.standard_normal(y.shape).astype(
            np.float32)
    labeled, mask = _labeled_mask(rng, V, num_labeled)
    data = NodeData(
        x=torch.from_numpy(x).to(dev),
        y=torch.from_numpy(y.astype(np.float32)).to(dev),
        sample_mask=torch.ones((V, samples_per_node), dtype=torch.float32,
                               device=dev),
        labeled_mask=torch.from_numpy(mask).to(dev),
    )
    return NetworkedDataset(
        graph=graph, data=data, w_true=torch.from_numpy(w_true).to(dev),
        clusters=(np.zeros(V, np.int64) if clusters is None
                  else np.asarray(clusters)),
        labeled_nodes=labeled,
    )


def make_classification_data(
    rng: np.random.Generator,
    graph: EmpiricalGraph,
    w_true: np.ndarray,
    samples_per_node: int = 8,
    num_labeled: int = 20,
    clusters: np.ndarray | None = None,
) -> NetworkedDataset:
    """Local logistic-classification datasets on an arbitrary graph.

    Binary labels y ~ Bernoulli(sigmoid(x^T wbar^(i))) for the §4.3
    logistic loss.  The tensors go to the graph's device.
    """
    V = graph.num_nodes
    dev = graph.device
    w_true = np.asarray(w_true, dtype=np.float32)
    n = w_true.shape[1]
    x = rng.standard_normal((V, samples_per_node, n)).astype(np.float32)
    logits = np.einsum("vmn,vn->vm", x, w_true)
    y = (rng.random(logits.shape) < 1.0 / (1.0 + np.exp(-logits))).astype(
        np.float32)
    labeled, mask = _labeled_mask(rng, V, num_labeled)
    data = NodeData(
        x=torch.from_numpy(x).to(dev), y=torch.from_numpy(y).to(dev),
        sample_mask=torch.ones((V, samples_per_node), dtype=torch.float32,
                               device=dev),
        labeled_mask=torch.from_numpy(mask).to(dev),
    )
    return NetworkedDataset(
        graph=graph, data=data, w_true=torch.from_numpy(w_true).to(dev),
        clusters=(np.zeros(V, np.int64) if clusters is None
                  else np.asarray(clusters)),
        labeled_nodes=labeled,
    )


def make_sbm_regression(
    seed: int = 0,
    cluster_sizes=(150, 150),
    p_in: float = 0.5,
    p_out: float = 1e-3,
    samples_per_node: int = 5,
    num_features: int = 2,
    num_labeled: int = 30,
    cluster_weights=None,
    label_noise: float = 0.0,
    device=None,
) -> NetworkedDataset:
    """Generate the paper's §5 setup (defaults exactly match the paper)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    graph, assign = sbm_graph(rng, cluster_sizes, p_in, p_out, device=dev)

    if cluster_weights is None:
        base = np.array([[2.0, 2.0], [-2.0, 2.0]])
        if num_features != 2 or len(cluster_sizes) > 2:
            base = rng.normal(size=(len(cluster_sizes), num_features)) * 2.0
        cluster_weights = base
    cluster_weights = np.asarray(cluster_weights, dtype=np.float32)

    return make_regression_data(
        rng, graph, cluster_weights[assign],
        samples_per_node=samples_per_node, num_labeled=num_labeled,
        noise_scale=label_noise, clusters=assign)


def make_classification_sbm(
    seed: int = 0,
    cluster_sizes=(100, 100),
    p_in: float = 0.5,
    p_out: float = 1e-3,
    samples_per_node: int = 8,
    num_features: int = 2,
    num_labeled: int = 20,
    device=None,
) -> NetworkedDataset:
    """Binary-label variant for the logistic loss (paper §4.3)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    graph, assign = sbm_graph(rng, cluster_sizes, p_in, p_out, device=dev)
    base = np.array([[3.0, 3.0], [-3.0, 3.0]])
    if num_features != 2 or len(cluster_sizes) > 2:
        base = rng.normal(size=(len(cluster_sizes), num_features)) * 3.0
    return make_classification_data(
        rng, graph, base[assign], samples_per_node=samples_per_node,
        num_labeled=num_labeled, clusters=assign)
