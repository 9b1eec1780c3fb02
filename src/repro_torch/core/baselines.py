"""Table-1 baselines: pooled linear regression and CART decision tree.

The paper compares Algorithm 1 against "simple linear regression" and
"decision tree regression" applied to the concatenation of all (labeled)
local datasets, ignoring the network structure.  Both baselines are
implemented from scratch in numpy, as in the reference
(``repro.core.baselines``): host code that reads the data's tensors
through :func:`repro_torch.device.to_host` (from any device), so its
results are the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.losses import NodeData
from repro_torch.device import to_host


def _masks(data: NodeData):
    """The data as host arrays: x, y and the boolean sample and labeled
    masks."""
    return (to_host(data.x), to_host(data.y), to_host(data.sample_mask) > 0,
            to_host(data.labeled_mask) > 0)


def _pool(data: NodeData, labeled_only: bool = True):
    x, y, sm, lm = _masks(data)
    if labeled_only:
        keep = lm[:, None] & sm
    else:
        keep = sm
    return x[keep], y[keep]


def pooled_linear_regression(data: NodeData) -> np.ndarray:
    """Least-squares fit on the concatenation of all labeled local datasets."""
    x, y = _pool(data)
    w, *_ = np.linalg.lstsq(x, y, rcond=None)
    return w


def linreg_mse(data: NodeData, w: np.ndarray, on: str = "all") -> float:
    """Prediction MSE of a single global linear model.

    on="train": labeled nodes only; on="test": unlabeled; on="all": both.
    """
    x, y, sm, lm = _masks(data)
    w = to_host(w)
    if on == "train":
        keep = lm[:, None] & sm
    elif on == "test":
        keep = (~lm)[:, None] & sm
    else:
        keep = sm
    pred = x @ w
    return float(np.mean((pred[keep] - y[keep]) ** 2))


# ---------------------------------------------------------------------------
# CART regression tree (axis-aligned splits, variance reduction)
# ---------------------------------------------------------------------------

class DecisionTreeRegressor:
    """Minimal CART regressor (MSE criterion), numpy-only."""

    def __init__(self, max_depth: int = 8, min_samples_split: int = 10,
                 min_samples_leaf: int = 5):
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self._nodes: list[tuple] = []   # (feat, thresh, left, right) | (None, value)

    def fit(self, x: np.ndarray, y: np.ndarray) -> "DecisionTreeRegressor":
        self._nodes = []
        self._build(x, y, depth=0)
        return self

    def _build(self, x, y, depth) -> int:
        idx = len(self._nodes)
        self._nodes.append(None)  # placeholder
        n = len(y)
        if (depth >= self.max_depth or n < self.min_samples_split
                or np.ptp(y) < 1e-12):
            self._nodes[idx] = (None, float(np.mean(y)) if n else 0.0, -1, -1)
            return idx
        best = None  # (sse, feat, thresh)
        for f in range(x.shape[1]):
            order = np.argsort(x[:, f], kind="stable")
            xs, ys = x[order, f], y[order]
            csum = np.cumsum(ys)
            csq = np.cumsum(ys ** 2)
            tot_sum, tot_sq = csum[-1], csq[-1]
            ks = np.arange(1, n)
            valid = (xs[1:] > xs[:-1]) & (ks >= self.min_samples_leaf) & \
                    (n - ks >= self.min_samples_leaf)
            if not valid.any():
                continue
            lsum, lsq = csum[:-1], csq[:-1]
            rsum, rsq = tot_sum - lsum, tot_sq - lsq
            sse = (lsq - lsum ** 2 / ks) + (rsq - rsum ** 2 / (n - ks))
            sse = np.where(valid, sse, np.inf)
            k = int(np.argmin(sse))
            if best is None or sse[k] < best[0]:
                best = (float(sse[k]), f, float((xs[k] + xs[k + 1]) / 2.0))
        if best is None:
            self._nodes[idx] = (None, float(np.mean(y)), -1, -1)
            return idx
        _, f, t = best
        mask = x[:, f] <= t
        left = self._build(x[mask], y[mask], depth + 1)
        right = self._build(x[~mask], y[~mask], depth + 1)
        self._nodes[idx] = (f, t, left, right)
        return idx

    def predict(self, x: np.ndarray) -> np.ndarray:
        out = np.empty(len(x))
        for r, row in enumerate(x):
            i = 0
            while True:
                f, t, l, rr = self._nodes[i]
                if f is None:
                    out[r] = t
                    break
                i = l if row[f] <= t else rr
        return out


def decision_tree_mse(data: NodeData, on: str = "all",
                      max_depth: int = 8) -> float:
    """Fit CART on pooled labeled data; report prediction MSE."""
    xtr, ytr = _pool(data)
    tree = DecisionTreeRegressor(max_depth=max_depth).fit(xtr, ytr)
    x, y, sm, lm = _masks(data)
    if on == "train":
        keep = lm[:, None] & sm
    elif on == "test":
        keep = (~lm)[:, None] & sm
    else:
        keep = sm
    pred = tree.predict(x[keep])
    return float(np.mean((pred - y[keep]) ** 2))
