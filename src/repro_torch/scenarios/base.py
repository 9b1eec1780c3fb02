"""The Scenario abstraction: one registered networked-learning workload.

A :class:`Scenario` bundles one point of the workload space — graph
family x data model x loss/regularizer choice x reference metric —
behind a uniform ``build(seed) -> ScenarioInstance`` interface, as
``repro.scenarios.base`` does.  Builders draw on the host (numpy, on the
CPU); ``build`` moves the instance to the device the caller names
(``None`` = CUDA, see :mod:`repro_torch.device`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.api import Problem
from repro_torch.core.graph import graph_signal_mse
from repro_torch.data.synthetic import NetworkedDataset
from repro_torch.device import resolve_device

SCENARIOS: dict[str, "Scenario"] = {}


@dataclasses.dataclass(frozen=True)
class ScenarioInstance:
    """One realized scenario: a ready Problem plus its ground truth."""

    scenario: "Scenario"
    problem: Problem
    dataset: NetworkedDataset

    @property
    def name(self) -> str:
        return self.scenario.name

    @property
    def w_true(self) -> torch.Tensor:
        return self.dataset.w_true

    def evaluate(self, w: torch.Tensor,
                 lam: float | None = None) -> dict[str, float]:
        """Reference metrics at a solution ``w``.

        Always: the primal objective and the eq.-24 weight MSE over the
        unlabeled (test) nodes.  Classification scenarios add test-node
        label accuracy; regression scenarios add test-node prediction MSE
        (both in numpy on the host).  ``lam`` overrides the TV strength
        the objective is evaluated at.
        """
        ds = self.dataset
        problem = self.problem if lam is None else self.problem.with_lam(lam)
        unlabeled = 1.0 - ds.data.labeled_mask
        out = {
            "objective": float(problem.objective(w)),
            "weight_mse": float(graph_signal_mse(w, ds.w_true, unlabeled)),
        }
        x = ds.data.x.cpu().numpy()
        y = ds.data.y.cpu().numpy()
        pred = np.einsum("vmn,vn->vm", x, w.cpu().numpy())
        test = unlabeled.cpu().numpy() > 0
        if self.scenario.metric == "accuracy":
            out["accuracy"] = float(
                np.mean((pred[test] > 0) == (y[test] > 0.5)))
        else:
            out["prediction_mse"] = float(np.mean((pred[test] - y[test]) ** 2))
        return out


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A registered workload template (graph x data x loss x regularizer).

    ``builder(rng, smoke)`` draws the graph and local datasets on the
    host; ``build`` wraps them into a ready :class:`~repro_torch.api.
    Problem` on a device at the scenario's reference TV strength (or a
    caller override).  ``lam_path`` is the default sweep grid.
    """

    name: str
    description: str
    graph_family: str
    data_model: str
    loss: str
    regularizer: str
    lam: float
    lam_path: tuple[float, ...]
    metric: str                       # "mse" | "accuracy"
    builder: Callable[[np.random.Generator, bool], NetworkedDataset]
    loss_kwargs: tuple[tuple[str, float], ...] = ()

    def build(self, seed: int = 0, *, smoke: bool = False,
              lam: float | None = None, device=None) -> ScenarioInstance:
        """Realize the scenario on ``device``: same seed -> the same
        instance as the reference's ``build(seed)``."""
        dev = resolve_device(device)
        ds = self.builder(np.random.default_rng(seed), smoke)
        ds = dataclasses.replace(ds, graph=ds.graph.to(dev),
                                 data=ds.data.to(dev),
                                 w_true=ds.w_true.to(dev))
        problem = Problem.create(
            ds.graph, ds.data, self.lam if lam is None else lam,
            loss=self.loss, regularizer=self.regularizer, device=dev,
            **dict(self.loss_kwargs))
        return ScenarioInstance(scenario=self, problem=problem, dataset=ds)


def register_scenario(name: str, *, description: str, graph_family: str,
                      data_model: str, loss: str = "squared",
                      regularizer: str = "tv", lam: float = 1e-3,
                      lam_path: tuple[float, ...] = (),
                      metric: str = "mse", loss_kwargs: dict | None = None):
    """Decorator registering a builder function as a :class:`Scenario`.

    The decorated ``builder(rng, smoke)`` must return a
    :class:`NetworkedDataset`; the decorator replaces it with the
    registered Scenario object (so module attributes *are* scenarios).
    """
    def deco(builder) -> Scenario:
        if name in SCENARIOS:
            raise ValueError(f"scenario {name!r} already registered")
        scenario = Scenario(
            name=name, description=description, graph_family=graph_family,
            data_model=data_model, loss=loss, regularizer=regularizer,
            lam=lam, lam_path=tuple(lam_path) or (lam,), metric=metric,
            builder=builder,
            loss_kwargs=tuple(sorted((loss_kwargs or {}).items())))
        SCENARIOS[name] = scenario
        return scenario
    return deco


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; registered: {sorted(SCENARIOS)}")


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)
