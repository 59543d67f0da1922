"""Deterministic counter-based synthetic data pipeline.

A copy of ``repro/data/pipeline.py`` (numpy only), so that the port needs
nothing of the JAX package.  ``batch(step)`` is a pure function of (seed,
step, row range), so

  * checkpoint/resume needs only the integer step (no iterator state),
  * each host/slice loads exactly its row shard (``lo:hi``) with no
    coordination, and
  * elastic re-sharding after a failure is a pure re-partition of rows.

Two modes:
  * "uniform": i.i.d. tokens (throughput benchmarking).
  * "markov":  per-sequence affine recurrence t_{i+1} = a*t_i + b (mod V),
    a learnable structure so example training runs show loss decreasing.

:func:`batch_to_device` moves a batch onto a device as integer tensors.
"""
from __future__ import annotations

import numpy as np
import torch


class DataPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, mode: str = "markov"):
        if mode not in ("uniform", "markov"):
            raise ValueError(f"unknown data mode {mode!r}")
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.global_batch = int(global_batch)
        self.seed = int(seed)
        self.mode = mode

    # -- core ---------------------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(key=[self.seed, step]))

    def batch(self, step: int, lo: int = 0, hi: int | None = None) -> dict:
        """Rows [lo, hi) of the global batch at `step` -> {"tokens","labels"}."""
        hi = self.global_batch if hi is None else hi
        n = hi - lo
        rng = self._rng(step)
        V, S = self.vocab_size, self.seq_len
        if self.mode == "uniform":
            all_tokens = rng.integers(0, V, size=(self.global_batch, S + 1), dtype=np.int64)
            tokens = all_tokens[lo:hi]
        else:
            # affine recurrence per row; draw per-row (a, b, t0) deterministically
            a = rng.integers(1, 8, size=(self.global_batch,))
            b = rng.integers(0, V, size=(self.global_batch,))
            t0 = rng.integers(0, V, size=(self.global_batch,))
            a, b, t0 = a[lo:hi], b[lo:hi], t0[lo:hi]
            tokens = np.empty((n, S + 1), dtype=np.int64)
            tokens[:, 0] = t0
            for i in range(S):
                tokens[:, i + 1] = (a * tokens[:, i] + b) % V
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    # -- convenience ----------------------------------------------------------
    def shard_bounds(self, shard: int, n_shards: int) -> tuple[int, int]:
        per = self.global_batch // n_shards
        rem = self.global_batch % n_shards
        lo = shard * per + min(shard, rem)
        return lo, lo + per + (1 if shard < rem else 0)


def batch_to_device(batch: dict, device="cuda", dtype: torch.dtype = torch.int64) -> dict:
    """A numpy batch as integer tensors (int64 or int32) on ``device``."""
    if dtype not in (torch.int64, torch.int32):
        raise ValueError(f"batch_to_device: {dtype} is not an integer index type")
    return {k: torch.from_numpy(np.asarray(v)).to(device=device, dtype=dtype)
            for k, v in batch.items()}
