"""LM training data pipeline (the reference package's ``train/data.py``,
numpy, imports rewritten): packs the synthetic LMaaS corpus (instruction
+ input + scripted response lengths) into fixed-length
next-token-prediction batches — deterministic, shardable, restartable.
The batches are numpy arrays, equal to the reference's for the same
config and seed; the trainer moves them to its device."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.workload.apps import make_dataset
from repro_torch.workload.tokenizer import EOS_ID, encode


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 256
    seed: int = 0


def corpus_tokens(vocab_size: int, n_per_task: int = 50, seed: int = 0
                  ) -> np.ndarray:
    """One long token stream from the synthetic application corpus."""
    reqs = make_dataset(n_per_task, seed=seed)
    stream = []
    for r in reqs:
        stream += encode(f"{r.instruction} {r.user_input}", vocab_size)
        stream.append(EOS_ID)
    return np.array(stream, np.int32)


def batches(cfg: ModelConfig, dc: DataConfig,
            n_per_task: int = 50) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {"tokens": [B, S]} packed LM batches."""
    stream = corpus_tokens(cfg.vocab_size, n_per_task, dc.seed)
    rng = np.random.default_rng(dc.seed)
    n_windows = len(stream) // dc.seq_len
    assert n_windows >= dc.batch_size, "corpus too small for batch shape"
    while True:
        idx = rng.integers(0, n_windows, size=dc.batch_size)
        toks = np.stack([stream[i * dc.seq_len:(i + 1) * dc.seq_len]
                         for i in idx])
        batch = {"tokens": toks}
        if cfg.family == "vlm":
            batch["patches"] = rng.normal(
                0, 1, (dc.batch_size, cfg.num_patches, cfg.d_model)
            ).astype(np.float32)
        if cfg.family == "audio":
            batch["frames"] = rng.normal(
                0, 1, (dc.batch_size, cfg.encoder_seq, cfg.d_model)
            ).astype(np.float32)
        yield batch
