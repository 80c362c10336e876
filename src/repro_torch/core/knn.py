"""K-nearest-neighbour regressor, from scratch (paper §III-D: serving-time
estimation from (batch size, batch length, batch generation length))."""
from __future__ import annotations

from typing import Optional

import numpy as np


class KNNRegressor:
    """Brute-force KNN with per-feature standardization and inverse-distance
    weighting — the training sets here are O(10^3) rows, brute force is the
    right tool."""

    def __init__(self, k: int = 5, weighted: bool = True):
        self.k = k
        self.weighted = weighted
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._mu = self._sigma = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> "KNNRegressor":
        x = np.asarray(x, np.float32)
        self._mu = x.mean(axis=0)
        self._sigma = x.std(axis=0) + 1e-6
        self._x = (x - self._mu) / self._sigma
        self._y = np.asarray(y, np.float32)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        if self._x is None:
            raise RuntimeError("fit() before predict()")
        x = np.atleast_2d(np.asarray(x, np.float32))
        xn = (x - self._mu) / self._sigma
        d2 = ((xn[:, None, :] - self._x[None, :, :]) ** 2).sum(-1)
        k = min(self.k, len(self._x))
        nn = np.argpartition(d2, k - 1, axis=1)[:, :k]
        dy = self._y[nn]
        if not self.weighted:
            return dy.mean(axis=1)
        w = 1.0 / (np.take_along_axis(d2, nn, axis=1) + 1e-6)
        return (dy * w).sum(axis=1) / w.sum(axis=1)
