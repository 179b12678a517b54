"""Pure-numpy multi-output decision-tree regressor (paper §III-C).

The paper fits sklearn's multi-output ``DecisionTreeRegressor`` (depth ≤ 5)
so the whole configuration is selected jointly rather than per parameter.
This is the reference package's CART (variance-reduction splits summed
over the outputs), copied so that the port imports nothing of it: fitted
on the same records, both predict the same. The fitted tree is consumed
by :mod:`repro_torch.core.codegen`, which emits branch-free if/else rules.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class _Node:
    # internal node
    feature: int = -1
    threshold: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    # leaf payload (multi-output mean)
    value: Optional[np.ndarray] = None

    @property
    def is_leaf(self) -> bool:
        return self.value is not None


class MultiOutputDecisionTree:
    """CART regressor, multi-output, variance-reduction criterion."""

    def __init__(self, max_depth: int = 5, min_samples_leaf: int = 8,
                 min_samples_split: int = 16):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.min_samples_split = min_samples_split
        self.root: Optional[_Node] = None
        self.n_features_ = 0
        self.n_outputs_ = 0

    # -- fitting ----------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray) -> "MultiOutputDecisionTree":
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if y.ndim == 1:
            y = y[:, None]
        self.n_features_ = x.shape[1]
        self.n_outputs_ = y.shape[1]
        self.root = self._build(x, y, depth=0)
        return self

    def _build(self, x: np.ndarray, y: np.ndarray, depth: int) -> _Node:
        n = x.shape[0]
        if (depth >= self.max_depth or n < self.min_samples_split
                or self._pure(y)):
            return _Node(value=y.mean(axis=0))
        feat, thr, gain = self._best_split(x, y)
        if feat < 0 or gain <= 1e-12:
            return _Node(value=y.mean(axis=0))
        mask = x[:, feat] <= thr
        if mask.sum() < self.min_samples_leaf or (~mask).sum() < self.min_samples_leaf:
            return _Node(value=y.mean(axis=0))
        return _Node(feature=feat, threshold=thr,
                     left=self._build(x[mask], y[mask], depth + 1),
                     right=self._build(x[~mask], y[~mask], depth + 1))

    @staticmethod
    def _pure(y: np.ndarray) -> bool:
        return bool(np.all(y.var(axis=0) < 1e-12))

    def _best_split(self, x: np.ndarray, y: np.ndarray):
        n = x.shape[0]
        parent_sse = float(((y - y.mean(axis=0)) ** 2).sum())
        best = (-1, 0.0, 0.0)
        for f in range(self.n_features_):
            order = np.argsort(x[:, f], kind="stable")
            xs, ys = x[order, f], y[order]
            # cumulative sums for O(n) split evaluation across all outputs
            csum = np.cumsum(ys, axis=0)
            csq = np.cumsum(ys ** 2, axis=0)
            tot_sum, tot_sq = csum[-1], csq[-1]
            for i in range(self.min_samples_leaf - 1,
                           n - self.min_samples_leaf):
                if xs[i] == xs[i + 1]:
                    continue
                nl = i + 1
                nr = n - nl
                sse_l = float((csq[i] - csum[i] ** 2 / nl).sum())
                sse_r = float(((tot_sq - csq[i])
                               - (tot_sum - csum[i]) ** 2 / nr).sum())
                gain = parent_sse - (sse_l + sse_r)
                if gain > best[2]:
                    best = (f, float((xs[i] + xs[i + 1]) / 2.0), gain)
        return best

    # -- inference --------------------------------------------------------
    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        single = x.ndim == 1
        if single:
            x = x[None]
        out = np.stack([self._predict_one(row) for row in x])
        return out[0] if single else out

    def _predict_one(self, row: np.ndarray) -> np.ndarray:
        node = self.root
        assert node is not None, "tree not fitted"
        while not node.is_leaf:
            node = node.left if row[node.feature] <= node.threshold else node.right
        return node.value

    # -- introspection ----------------------------------------------------
    def num_leaves(self) -> int:
        def count(n: Optional[_Node]) -> int:
            if n is None:
                return 0
            return 1 if n.is_leaf else count(n.left) + count(n.right)
        return count(self.root)

    def depth(self) -> int:
        def d(n: Optional[_Node]) -> int:
            if n is None or n.is_leaf:
                return 0
            return 1 + max(d(n.left), d(n.right))
        return d(self.root)
