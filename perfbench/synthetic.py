"""Seeded token streams: splitmix64 over (seed, stream, position).

The arithmetic is a frozen copy of the port's ``data/synthetic.py``
(``_splitmix64`` and the position layout of ``token_batch``), so that a
change to the program cannot move the yardstick's inputs. The seed is
folded to 24 bits before it is shifted into place, so that any whole number
(a seed may exceed 32 bits) gives a stream of its own without
overflowing the 64-bit position.
"""
from __future__ import annotations

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def fold_seed(seed: int) -> int:
    """``seed`` (any whole number) mixed down to 24 bits."""
    x = np.array([int(seed) % (1 << 64)], dtype=np.uint64)
    with np.errstate(over="ignore"):
        return int(_splitmix64(x)[0] >> np.uint64(40))


def tokens(seed: int, stream: int, rows: int, length: int, vocab: int) -> np.ndarray:
    """(rows, length) int32 tokens in [0, vocab) of ``stream`` (a request id,
    or a training step) under ``seed``: ``token_batch``'s layout, the
    position being ``(seed << 40) ^ (stream << 20)`` plus the element's index."""
    base = (np.uint64(fold_seed(seed)) << np.uint64(40)) ^ (np.uint64(stream) << np.uint64(20))
    pos = np.arange(rows * length, dtype=np.uint64) + base
    with np.errstate(over="ignore"):
        raw = _splitmix64(pos)
    return (raw % np.uint64(vocab)).astype(np.int32).reshape(rows, length)


def train_batch(seed: int, step: int, batch: int, seq: int, vocab: int):
    """``token_batch``'s training batch of one step: ``(tokens, labels)``,
    each (batch, seq), the labels the next tokens."""
    toks = tokens(seed, step, batch, seq + 1, vocab)
    return toks[:, :-1], toks[:, 1:]
