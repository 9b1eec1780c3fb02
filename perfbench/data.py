"""Node-local datasets drawn from ``--seed`` on the device.

Each node i of cluster c(i) has a true weight vector, the
configuration's ``truths[c(i) % len(truths)]`` (the paper's §5:
(2, 2) and (-2, 2) in alternating clusters), m i.i.d. standard normal
feature rows, and targets: the squared loss's noiseless x^T w_i, the
logistic loss's labels y ~ Bernoulli(sigmoid(x^T w_i)) (as
``data/synthetic.py:make_classification_data`` draws them).  A share
``labeled_fraction`` of the nodes, drawn uniformly, carries a loss;
every seed gives the same counts and shapes, so only values and order
change with it.  Everything is drawn by one ``torch.Generator`` on the
device, in a few large calls a dataset.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import losses


@dataclasses.dataclass
class Dataset:
    """One dataset: x (V, m, n), y (V, m), labeled (V,) bool."""

    x: torch.Tensor
    y: torch.Tensor
    labeled: torch.Tensor


def true_weights(config: dict, assign: torch.Tensor) -> torch.Tensor:
    truths = torch.tensor(config["truths"], dtype=torch.float32,
                          device=assign.device)
    return truths[assign.long() % truths.shape[0]]


def labeled_count(config: dict) -> int:
    v = int(config["graph"]["nodes"])
    return max(int(round(float(config["labeled_fraction"]) * v)), 1)


def draw(config: dict, w_true: torch.Tensor,
         gen: torch.Generator) -> Dataset:
    """One dataset of the configuration on ``w_true``'s device, drawn by
    ``gen`` in a few large calls."""
    dev = w_true.device
    v, m, n = (int(config["graph"]["nodes"]), int(config["samples"]),
               int(config["features"]))
    x = torch.randn((v, m, n), generator=gen, device=dev)
    y = losses.load(config["loss"]).targets(x, w_true, gen)
    lab = torch.zeros(v, dtype=torch.bool, device=dev)
    lab[torch.randperm(v, generator=gen, device=dev)[
        :labeled_count(config)]] = True
    return Dataset(x=x, y=y, labeled=lab)


def make_pool(config: dict, assign: torch.Tensor, seed: int,
              count: int) -> list[Dataset]:
    """``count`` datasets of the configuration on ``assign``'s device,
    drawn in turn by one generator seeded with ``seed``."""
    gen = torch.Generator(device=assign.device)
    gen.manual_seed(int(seed))
    w_true = true_weights(config, assign)
    return [draw(config, w_true, gen) for _ in range(count)]


def pool_states(config: dict, assign: torch.Tensor, seed: int,
                count: int) -> list[torch.Tensor]:
    """The generator's state before each of ``make_pool``'s draws, so
    that a run holds no dataset it is not using: ``redraw`` makes
    dataset p again from the p-th state, the same values."""
    gen = torch.Generator(device=assign.device)
    gen.manual_seed(int(seed))
    w_true = true_weights(config, assign)
    states = []
    for _ in range(count):
        states.append(gen.get_state())
        draw(config, w_true, gen)
    return states


def redraw(config: dict, w_true: torch.Tensor,
           state: torch.Tensor) -> Dataset:
    """The dataset drawn from generator state ``state``."""
    gen = torch.Generator(device=w_true.device)
    gen.set_state(state)
    return draw(config, w_true, gen)


class Drift:
    """The serving traffic's data drift: request k redraws the targets
    of ``fraction`` of the labeled nodes from their true weights, plus
    the loss's noise (``drift``: Gaussian of standard deviation
    ``noise`` for the squared loss, none for drawn labels).
    Nodes and noise come from a numpy generator seeded from ``--seed``;
    the rows are computed on the device and handed over as host arrays,
    as a client hands over new data."""

    def __init__(self, config: dict, ds: Dataset, w_true: torch.Tensor,
                 seed: int, *, fraction: float, noise: float):
        self.config = config
        self.rng = np.random.default_rng([int(seed), 7])
        self.gen = torch.Generator(device=ds.x.device)
        self.gen.manual_seed(int(seed) + 1)
        self.labeled = torch.nonzero(ds.labeled).reshape(-1).cpu().numpy()
        self.k = max(int(round(fraction * self.labeled.size)), 1)
        self.noise = float(noise)
        self.x, self.w_true = ds.x, w_true

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        """(nodes, new y rows) of the next request."""
        nodes = np.sort(self.rng.choice(self.labeled, size=self.k,
                                        replace=False))
        idx = torch.from_numpy(nodes).to(self.x.device)
        loss = losses.load(self.config["loss"])
        y = loss.drift(loss.targets(self.x[idx], self.w_true[idx],
                                    self.gen), self.noise, self.gen)
        return nodes, y.cpu().numpy()
