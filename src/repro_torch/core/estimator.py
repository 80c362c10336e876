"""Serving-time estimator — KNN regression on (batch size, batch length,
batch generation length), paper §III-D, with continuous learning (every
2 min; samples whose error is > 2 s AND > 20% of actual serving time)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.knn import KNNRegressor
from repro_torch.core.types import Batch


@dataclasses.dataclass
class EstimatorConfig:
    k: int = 5
    err_seconds: float = 2.0
    err_frac: float = 0.20
    retrain_period: float = 120.0   # "every 2 minutes"
    max_train: int = 50_000


def batch_features(size: int, length: int, gen_length: int) -> np.ndarray:
    return np.array([size, length, gen_length], np.float32)


class ServingTimeEstimator:
    def __init__(self, config: Optional[EstimatorConfig] = None):
        self.cfg = config or EstimatorConfig()
        self.knn = KNNRegressor(k=self.cfg.k)
        self._x: List[np.ndarray] = []
        self._y: List[float] = []
        self._last_retrain = 0.0
        self.n_retrains = 0

    def fit(self, rows: Sequence[Tuple[int, int, int, float]]):
        """rows: (batch_size, batch_len, batch_gen_len, serving_time)."""
        self._x = [batch_features(*r[:3]) for r in rows]
        self._y = [float(r[3]) for r in rows]
        self.knn.fit(np.stack(self._x), np.array(self._y))
        return self

    def estimate(self, batch: Batch) -> float:
        """Uses the max *predicted* generation length as G(B)."""
        x = batch_features(batch.size, batch.length,
                           batch.predicted_gen_length)[None]
        return float(self.knn.predict(x)[0])

    def rmse(self, rows: Sequence[Tuple[int, int, int, float]]) -> float:
        preds = self.knn.predict(np.stack([batch_features(*r[:3])
                                           for r in rows]))
        actual = np.array([r[3] for r in rows], np.float32)
        return float(np.sqrt(np.mean((preds - actual) ** 2)))

    def observe(self, size: int, length: int, gen_length: int,
                predicted_time: float, actual_time: float,
                now: float) -> bool:
        """Continuous learning: re-predict with the *actual* generation
        length, add high-error samples, periodic refit."""
        err = abs(predicted_time - actual_time)
        if err > self.cfg.err_seconds and err > self.cfg.err_frac * max(
                actual_time, 1e-9):
            self._x.append(batch_features(size, length, gen_length))
            self._y.append(float(actual_time))
        if (now - self._last_retrain >= self.cfg.retrain_period
                and len(self._x) > 0):
            self._last_retrain = now
            self.knn.fit(np.stack(self._x[-self.cfg.max_train:]),
                         np.array(self._y[-self.cfg.max_train:]))
            self.n_retrains += 1
            return True
        return False
