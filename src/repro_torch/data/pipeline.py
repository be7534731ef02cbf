"""Deterministic synthetic data pipeline with exact-resume semantics.

Production posture: the loader is a pure function of (seed, step, shard), so
a restarted job resumes mid-epoch with zero duplication/loss — checkpointing
stores only the step counter.  Token streams are generated from a seeded
Zipf-ish unigram mixture with Markov bigram structure so losses actually
*decrease* during the example runs (pure-uniform tokens would pin loss at
ln V and hide training bugs).

The port's copy of the JAX package's ``data/pipeline.py``: NumPy only, so
under one NumPy a batch is bitwise the reference's at any (seed, step), the
embeddings and ``positions3`` frontends included (``Generator.zipf`` draws
other numbers in other NumPy versions).  Batches stay NumPy arrays; the trainer
moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "make_batch_for_shape"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: str = "tokens"      # tokens | embeddings
    d_model: int = 0              # for embedding frontends
    mrope: bool = False


class SyntheticLM:
    """Stateless-per-step loader: batch(step) is pure, resume = set step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # fixed Markov structure: each token prefers a small successor set
        self._succ = root.integers(0, v, size=(v, 4))
        self._unigram = root.zipf(1.3, size=v * 4) % v

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        follow = rng.random((b, s)) < 0.7
        nxt_choice = rng.integers(0, 4, size=(b, s))
        rand_tok = self._unigram[rng.integers(0, self._unigram.size, size=(b, s))]
        for t in range(s):
            nxt = self._succ[toks[:, t], nxt_choice[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, rand_tok[:, t])
        out: Dict[str, np.ndarray] = {"labels": toks[:, 1:].astype(np.int32)}
        if cfg.frontend == "tokens":
            out["tokens"] = toks[:, :-1].astype(np.int32)
        else:
            emb_rng = np.random.default_rng((cfg.seed, step, 7))
            out["embeddings"] = emb_rng.normal(
                0, 1, size=(b, s, cfg.d_model)).astype(np.float32)
        if cfg.mrope:
            base = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
            out["positions3"] = np.stack([base, base, base], axis=1)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch_for_shape(cfg_model, shape, seed: int = 0) -> Dict[str, np.ndarray]:
    """One concrete batch matching a dry-run ShapeSpec (for smoke runs)."""
    dc = DataConfig(vocab=cfg_model.vocab, seq_len=shape.seq_len,
                    global_batch=shape.global_batch, seed=seed,
                    frontend=cfg_model.frontend, d_model=cfg_model.d_model,
                    mrope=cfg_model.mrope)
    return SyntheticLM(dc).batch(0)
