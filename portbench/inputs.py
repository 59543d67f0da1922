"""Everything a cell's run is fed, made from ``--seed`` on the device: the
weights, the encoder's frames, prompt tokens, first decode tokens and the
contents of a decode cache below each sequence's start.

The program and the reference are handed the same tensors; what the
reference needs again after the program's state is freed (a cache's first
contents) it makes again from the same seed, by the same calls in the same
order.  Each leaf of the weights is one ``normal_`` call in the dtype it is
served in.
"""
from __future__ import annotations

import math

import torch

NORMS = ("ln1", "ln2", "ln_x", "enc_norm", "final_norm")
BIASES = ("bq", "bk", "bv")
_MIX = 0x9E3779B97F4A7C15


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each input stream of a run (64 bits)."""
    return (int(seed) * _MIX + stream * 0xBF58476D1CE4E5B9) % (2 ** 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def _leaves(tree: dict, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def _std(path: tuple, shape: tuple) -> float:
    name = path[-1]
    if name == "emb":
        return 0.02
    if name in BIASES:
        return 0.1
    return 1.0 / math.sqrt(shape[-2])      # (.., in, out) matrices: 1 / sqrt(fan-in)


def make_weights(template: dict, seed: int, device) -> dict:
    """A tree of the keys, shapes and dtypes of ``template`` (meta tensors)
    on ``device``: norm scales 1 + N(0, 0.1^2), q/k/v biases N(0, 0.1^2),
    the embedding N(0, 0.02^2), every matrix N(0, 1 / fan-in)."""
    gen = generator(seed, 1, device)
    out: dict = {}
    for path, meta in _leaves(template):
        t = torch.empty(meta.shape, dtype=meta.dtype, device=device)
        if path[-1] in NORMS:
            t.normal_(1.0, 0.1, generator=gen)
        else:
            t.normal_(0.0, _std(path, tuple(meta.shape)), generator=gen)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def frames(seed: int, index: int, batch: int, n: int, width: int, device) -> torch.Tensor:
    """Encoder frame embeddings (batch, n, width), bf16 N(0, 1); set ``index``."""
    gen = generator(seed, 10 + index, device)
    return torch.empty((batch, n, width), dtype=torch.bfloat16, device=device).normal_(
        generator=gen)


def tokens(seed: int, index: int, shape: tuple, vocab: int, device) -> torch.Tensor:
    """Token ids uniform over the vocabulary; set ``index``."""
    gen = generator(seed, 100 + index, device)
    return torch.randint(0, vocab, shape, generator=gen, device=device)


def cache_slabs(seed: int, stream: int, layers: int, shape: tuple, dtype, device):
    """``(layer, k, v)``: the first contents of a decode cache's layers,
    N(0, 1), one fresh (B, Smax, Hkv, D) slab for each of K and V in turn.
    The same arguments give the same slabs."""
    gen = generator(seed, 1000 + stream, device)
    for i in range(layers):
        k = torch.empty(shape, dtype=dtype, device=device).normal_(generator=gen)
        v = torch.empty(shape, dtype=dtype, device=device).normal_(generator=gen)
        yield i, k, v
