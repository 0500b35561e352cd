"""The port's copy of ``tpushare/utils/data.py`` (numpy only; a test holds
its code equal to the original and its batches byte-equal).

Deterministic, resumable input pipeline for the training loop.

``trainer.fit``'s bit-exact resume contract is data-order determinism:
``batches`` must already be positioned at ``start_step``. Batch s is a
pure function of (corpus, seed, s), never of iterator history, so a
preempted tenant restores params, optimizer state and step from its
checkpoint, asks for the stream at ``start_step`` and continues bit for
bit. Every batch is the same [batch, seq+1] int32 array; the +1 column
is the next-token shift the train steps peel off, so a window holds
seq+1 tokens and consecutive windows overlap by one.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np


def load_tokens(path: str, dtype=np.uint16) -> np.ndarray:
    """Memory-map a flat binary token file (the standard tokenized-
    corpus format: one contiguous array of token ids). dtype must
    match the writer's (uint16 fits vocabs < 65536)."""
    size = os.path.getsize(path)
    item = np.dtype(dtype).itemsize
    if size % item:
        raise ValueError(
            f"{path}: {size} bytes is not a multiple of dtype "
            f"{np.dtype(dtype).name} ({item}B) — wrong dtype, header, "
            f"or truncated file")
    return np.memmap(path, dtype=dtype, mode="r", shape=(size // item,))


def n_windows(n_tokens: int, seq_len: int) -> int:
    """How many [seq_len+1] training windows a corpus yields (stride
    seq_len, one-token overlap for the target shift)."""
    return max(0, (n_tokens - 1) // seq_len)


def _epoch_order(n: int, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    if not shuffle:
        return np.arange(n)
    # Stateless per-epoch permutation: (seed, epoch) fully determines
    # the order, so any step's windows are computable without replay.
    return np.random.default_rng((seed, epoch)).permutation(n)


def _fill_batch(tokens, out, base: int, nw: int, seq_len: int, seed: int,
                shuffle: bool, cache: dict) -> None:
    """Fill ``out`` with the window slots [base, base+len(out)); the
    ONE copy of the slot->epoch->window arithmetic, shared by the
    stateless batch_at and the caching iterator (cache = {"epoch":
    int, "order": array} persists the epoch permutation between
    calls)."""
    for i in range(out.shape[0]):
        epoch, pos = divmod(base + i, nw)
        if epoch != cache.get("epoch"):
            cache["order"] = _epoch_order(nw, seed, epoch, shuffle)
            cache["epoch"] = epoch
        w = int(cache["order"][pos])
        out[i] = tokens[w * seq_len: w * seq_len + seq_len + 1]


def batch_at(tokens, step: int, *, batch_size: int, seq_len: int,
             seed: int = 0, shuffle: bool = True) -> np.ndarray:
    """The [batch_size, seq_len+1] int32 batch for optimizer step
    ``step`` — a pure function of (tokens, seed, step). Batches draw
    consecutive window slots from the per-epoch shuffled stream;
    epochs reshuffle (new (seed, epoch) permutation) and the stream
    concatenates epochs indefinitely."""
    nw = n_windows(len(tokens), seq_len)
    if nw == 0:
        raise ValueError(
            f"corpus of {len(tokens)} tokens has no {seq_len + 1}-token "
            f"window")
    out = np.empty((batch_size, seq_len + 1), np.int32)
    _fill_batch(tokens, out, step * batch_size, nw, seq_len, seed,
                shuffle, {})
    return out


def token_batches(tokens, *, batch_size: int, seq_len: int,
                  seed: int = 0, start_step: int = 0,
                  shuffle: bool = True) -> Iterator[np.ndarray]:
    """Infinite deterministic batch stream, positioned at
    ``start_step``: resuming at step s yields exactly the batches the
    uninterrupted stream would have yielded from s (trainer.fit's
    resume contract), with no replay cost.

    Unlike the stateless random-access batch_at (which rebuilds the
    epoch permutation per call), the iterator caches the current
    epoch's order across yields, so steady-state cost per batch is
    O(batch_size) even on memmap-scale corpora."""
    nw = n_windows(len(tokens), seq_len)
    if nw == 0:
        raise ValueError(
            f"corpus of {len(tokens)} tokens has no {seq_len + 1}-token "
            f"window")
    step = start_step
    cache: dict = {}         # epoch permutation persists across yields
    out = np.empty((batch_size, seq_len + 1), np.int32)
    while True:
        _fill_batch(tokens, out, step * batch_size, nw, seq_len, seed,
                    shuffle, cache)
        yield out.copy()     # callers may hold batches across steps
        step += 1
