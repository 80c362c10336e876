"""Generation-length predictor (paper §III-B).

Pipeline (faithful): sentence embedding of the *instruction* (application-
level semantics, d=768) and of the *user input* (user-level semantics,
d=768) -> group-sum compression to d_app=4 / d_user=16 (divided by
sqrt(group size) for numerical stability) -> concatenated with the user
input length -> random-forest regressor.

Hardware adaptation: LaBSE is replaced by a deterministic hashed n-gram
embedder with the same interface/dimension (no pretrained weights offline;
DESIGN.md §3).  Continuous learning (paper: every 3 min): requests whose
prediction error is > ``err_tokens`` AND > ``err_frac`` of the actual
generation length are appended to the train set and the forest is refit.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.forest import RandomForestRegressor
from repro_torch.core.types import Request

EMBED_DIM = 768


def _hash32(token: str, salt: int = 0) -> int:
    h = hashlib.blake2b(token.encode(), digest_size=8,
                        salt=salt.to_bytes(8, "little")).digest()
    return int.from_bytes(h, "little")


def hash_embed(text: str, dim: int = EMBED_DIM) -> np.ndarray:
    """Deterministic signed feature-hashing sentence embedding: unigrams +
    bigrams + char trigrams, L2-normalized.  Semantically similar texts
    (shared tokens/n-grams) land near each other — the property the paper
    exploits via LaBSE."""
    v = np.zeros(dim, np.float32)
    words = text.lower().split()
    grams: List[str] = list(words)
    grams += [f"{a}_{b}" for a, b in zip(words, words[1:])]
    joined = " ".join(words)
    grams += [joined[i:i + 3] for i in range(0, max(len(joined) - 2, 0), 2)]
    for g in grams:
        h = _hash32(g)
        v[h % dim] += 1.0 if (h >> 33) & 1 else -1.0
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def compress(v: np.ndarray, groups: int) -> np.ndarray:
    """Paper's compression module: split into ``groups`` groups, sum each,
    divide by sqrt(group size)."""
    d = v.shape[-1]
    assert d % groups == 0, (d, groups)
    gs = d // groups
    return v.reshape(*v.shape[:-1], groups, gs).sum(-1) / np.sqrt(gs)


@dataclasses.dataclass
class PredictorConfig:
    d_app: int = 4                 # paper §III-B
    d_user: int = 16
    n_trees: int = 20
    max_depth: int = 12
    err_tokens: float = 10.0       # continuous-learning thresholds
    err_frac: float = 0.10
    retrain_period: float = 180.0  # "every 3 minutes"
    use_instruction: bool = True   # ablations: INST
    use_user_input: bool = True    # ablations: USIN
    max_train: int = 50_000


class GenerationLengthPredictor:
    """UILO / RAFT / INST / USIN live in one class via PredictorConfig
    flags (Table II ablations)."""

    def __init__(self, config: Optional[PredictorConfig] = None, seed: int = 0):
        self.cfg = config or PredictorConfig()
        self.forest = RandomForestRegressor(
            n_trees=self.cfg.n_trees, max_depth=self.cfg.max_depth, seed=seed)
        self._x: List[np.ndarray] = []
        self._y: List[float] = []
        self._emb_cache: dict = {}
        self._last_retrain = 0.0
        self.n_retrains = 0

    # -- features ----------------------------------------------------------
    def _embed_cached(self, text: str) -> np.ndarray:
        key = hash(text)
        if key not in self._emb_cache:
            if len(self._emb_cache) > 100_000:
                self._emb_cache.clear()
            self._emb_cache[key] = hash_embed(text)
        return self._emb_cache[key]

    def features(self, req: Request) -> np.ndarray:
        parts = [np.array([req.user_input_length], np.float32)]
        if self.cfg.use_instruction:
            parts.append(compress(self._embed_cached(req.instruction),
                                  self.cfg.d_app))
        if self.cfg.use_user_input:
            parts.append(compress(self._embed_cached(req.user_input),
                                  self.cfg.d_user))
        return np.concatenate(parts).astype(np.float32)

    # -- training ----------------------------------------------------------
    def fit(self, requests: Sequence[Request]) -> "GenerationLengthPredictor":
        self._x = [self.features(r) for r in requests]
        self._y = [float(r.gen_length) for r in requests]
        self.forest.fit(np.stack(self._x), np.array(self._y))
        return self

    # -- inference ---------------------------------------------------------
    def predict(self, req: Request) -> int:
        x = self.features(req)[None]
        return max(1, int(round(float(self.forest.predict(x)[0]))))

    def predict_batch(self, requests: Sequence[Request]) -> List[int]:
        if not requests:
            return []
        x = np.stack([self.features(r) for r in requests])
        return [max(1, int(round(float(p)))) for p in self.forest.predict(x)]

    def rmse(self, requests: Sequence[Request]) -> float:
        preds = np.array(self.predict_batch(requests), np.float32)
        actual = np.array([r.gen_length for r in requests], np.float32)
        return float(np.sqrt(np.mean((preds - actual) ** 2)))

    # -- continuous learning (paper: async, every 3 min) --------------------
    def observe(self, req: Request, now: float) -> bool:
        """Log a served request; returns True if a retrain was triggered."""
        pred = req.predicted_gen_length or 0
        err = abs(pred - req.gen_length)
        if err > self.cfg.err_tokens and err > self.cfg.err_frac * max(
                req.gen_length, 1):
            self._x.append(self.features(req))
            self._y.append(float(req.gen_length))
        if (now - self._last_retrain >= self.cfg.retrain_period
                and len(self._x) > 0):
            self._last_retrain = now
            x = np.stack(self._x[-self.cfg.max_train:])
            y = np.array(self._y[-self.cfg.max_train:])
            self.forest.fit(x, y)
            self.n_retrains += 1
            return True
        return False


class UILOPredictor:
    """Table II baseline: the user input length *is* the prediction."""

    def fit(self, requests):  # noqa: D401 - interface parity
        return self

    def predict(self, req: Request) -> int:
        return max(1, req.user_input_length)

    def predict_batch(self, requests):
        return [self.predict(r) for r in requests]

    def rmse(self, requests) -> float:
        preds = np.array(self.predict_batch(requests), np.float32)
        actual = np.array([r.gen_length for r in requests], np.float32)
        return float(np.sqrt(np.mean((preds - actual) ** 2)))


class PerTaskForestPredictor:
    """Table II 'RAFT' baseline: one forest per task, UIL feature only."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.forests: dict = {}

    def fit(self, requests: Sequence[Request]):
        by_task: dict = {}
        for r in requests:
            by_task.setdefault(r.task, []).append(r)
        for task, reqs in by_task.items():
            x = np.array([[r.user_input_length] for r in reqs], np.float32)
            y = np.array([r.gen_length for r in reqs], np.float32)
            self.forests[task] = RandomForestRegressor(seed=self.seed).fit(x, y)
        return self

    def predict(self, req: Request) -> int:
        f = self.forests.get(req.task)
        if f is None:
            return max(1, req.user_input_length)
        return max(1, int(round(float(
            f.predict(np.array([[req.user_input_length]], np.float32))[0]))))

    def predict_batch(self, requests):
        return [self.predict(r) for r in requests]

    def rmse(self, requests) -> float:
        preds = np.array(self.predict_batch(requests), np.float32)
        actual = np.array([r.gen_length for r in requests], np.float32)
        return float(np.sqrt(np.mean((preds - actual) ** 2)))
