"""Deterministic synthetic data pipeline.

Produces a reproducible token stream (splitmix64 over (seed, step, position))
with next-token labels, packed to (B, S); per-family extras (patch/frame
embeddings) come from the same generator. Deterministic by (seed, step) so
restarts resume mid-epoch without a data-state checkpoint, and each DP shard
can generate only its slice at scale.
"""
from __future__ import annotations

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def token_batch(cfg, *, batch: int, seq: int, step: int, seed: int = 0,
                s_tok: int | None = None):
    """Returns the training batch dict for one step (numpy host arrays)."""
    s_tok = s_tok or seq
    idx = (np.uint64(seed) << np.uint64(40)) ^ (np.uint64(step) << np.uint64(20))
    pos = np.arange(batch * (s_tok + 1), dtype=np.uint64) + idx
    with np.errstate(over="ignore"):
        raw = _splitmix64(pos)
    toks = (raw % np.uint64(cfg.vocab_size)).astype(np.int32)
    toks = toks.reshape(batch, s_tok + 1)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        n = batch * cfg.frontend_len * cfg.d_model
        with np.errstate(over="ignore"):
            e = _splitmix64(np.arange(n, dtype=np.uint64) + idx)
        out["embeds"] = ((e % np.uint64(2000)).astype(np.float32) / 1000.0 - 1.0
                         ).reshape(batch, cfg.frontend_len, cfg.d_model) * 0.02
    if cfg.family == "encdec":
        n = batch * cfg.frontend_len * cfg.d_model
        with np.errstate(over="ignore"):
            e = _splitmix64(np.arange(n, dtype=np.uint64) + idx + np.uint64(7))
        out["frames"] = ((e % np.uint64(2000)).astype(np.float32) / 1000.0 - 1.0
                         ).reshape(batch, cfg.frontend_len, cfg.d_model) * 0.02
    return out


class DataIterator:
    """Stateless-resumable iterator: state is just (seed, step)."""

    def __init__(self, cfg, batch: int, seq: int, *, seed: int = 0,
                 start_step: int = 0, s_tok: int | None = None):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = start_step
        self.s_tok = s_tok

    def __iter__(self):
        return self

    def __next__(self):
        b = token_batch(self.cfg, batch=self.batch, seq=self.seq,
                        step=self.step, seed=self.seed, s_tok=self.s_tok)
        self.step += 1
        return b

    def state(self):
        return {"seed": self.seed, "step": self.step}
