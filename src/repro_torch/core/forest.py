"""Random-forest regressor, from scratch (no sklearn offline).

CART regression trees with variance-reduction splits (prefix-sum scan over
sorted feature values), bootstrap sampling and per-node feature subsampling.
Flattened-array tree storage keeps prediction a tight numpy loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class _Tree:
    feature: np.ndarray    # [nodes] int32, -1 = leaf
    threshold: np.ndarray  # [nodes] f32
    left: np.ndarray       # [nodes] int32
    right: np.ndarray      # [nodes] int32
    value: np.ndarray      # [nodes] f32

    def predict(self, x: np.ndarray) -> np.ndarray:
        idx = np.zeros(len(x), np.int32)
        active = self.feature[idx] >= 0
        while active.any():
            f = self.feature[idx]
            go_left = x[np.arange(len(x)), np.maximum(f, 0)] <= self.threshold[idx]
            nxt = np.where(go_left, self.left[idx], self.right[idx])
            idx = np.where(active, nxt, idx)
            active = self.feature[idx] >= 0
        return self.value[idx]


def _build_tree(x: np.ndarray, y: np.ndarray, *, max_depth: int,
                min_leaf: int, n_feats: int, rng: np.random.Generator
                ) -> _Tree:
    feats, thrs, lefts, rights, vals = [], [], [], [], []

    def new_node():
        feats.append(-1); thrs.append(0.0); lefts.append(-1)
        rights.append(-1); vals.append(0.0)
        return len(feats) - 1

    def grow(idx: np.ndarray, depth: int) -> int:
        node = new_node()
        vals[node] = float(y[idx].mean())
        if depth >= max_depth or len(idx) < 2 * min_leaf:
            return node
        best = None  # (score, feature, threshold)
        ys = y[idx]
        base = ys.var() * len(idx)
        if base <= 1e-12:
            return node
        cand = rng.choice(x.shape[1], size=min(n_feats, x.shape[1]),
                          replace=False)
        for f in cand:
            xs = x[idx, f]
            order = np.argsort(xs, kind="stable")
            xo, yo = xs[order], ys[order]
            csum = np.cumsum(yo)
            csq = np.cumsum(yo * yo)
            n = len(idx)
            nl = np.arange(1, n)
            # valid split points: min_leaf on both sides, distinct values
            sse_l = csq[:-1] - csum[:-1] ** 2 / nl
            nr = n - nl
            sse_r = (csq[-1] - csq[:-1]) - (csum[-1] - csum[:-1]) ** 2 / nr
            sse = sse_l + sse_r
            ok = (nl >= min_leaf) & (nr >= min_leaf) & (xo[:-1] < xo[1:])
            if not ok.any():
                continue
            sse = np.where(ok, sse, np.inf)
            i = int(np.argmin(sse))
            if sse[i] < (best[0] if best else base - 1e-9):
                # threshold = exact left value: "x <= t" is then guaranteed
                # to put i+1.. on the right (no f32 midpoint rounding).
                best = (sse[i], int(f), float(xo[i]))
        if best is None:
            return node
        _, f, t = best
        mask = x[idx, f] <= t
        if not mask.any() or mask.all():   # degenerate split: leaf
            return node
        l = grow(idx[mask], depth + 1)
        r = grow(idx[~mask], depth + 1)
        feats[node], thrs[node], lefts[node], rights[node] = f, t, l, r
        return node

    grow(np.arange(len(x)), 0)
    return _Tree(np.array(feats, np.int32), np.array(thrs, np.float32),
                 np.array(lefts, np.int32), np.array(rights, np.int32),
                 np.array(vals, np.float32))


class RandomForestRegressor:
    def __init__(self, n_trees: int = 20, max_depth: int = 12,
                 min_leaf: int = 2, feature_frac: float = 0.7,
                 seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.feature_frac = feature_frac
        self.seed = seed
        self.trees: list[_Tree] = []

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        rng = np.random.default_rng(self.seed)
        n_feats = max(1, int(round(self.feature_frac * x.shape[1])))
        self.trees = []
        for _ in range(self.n_trees):
            boot = rng.integers(0, len(x), size=len(x))
            self.trees.append(_build_tree(
                x[boot], y[boot], max_depth=self.max_depth,
                min_leaf=self.min_leaf, n_feats=n_feats, rng=rng))
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x, np.float32))
        if not self.trees:
            raise RuntimeError("fit() before predict()")
        return np.mean([t.predict(x) for t in self.trees], axis=0)
