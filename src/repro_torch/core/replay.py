"""Experience replay: uniform + prioritized, device tensors and numpy mirror.

Port of ``repro/core/replay.py``.  Two storage layers share one ring-buffer
contract (block-aligned writes, see :func:`replay_push`):

  * ``ReplayState`` + ``replay_init/push/sample`` — the uniform ring the
    batched training loop (``train.py``) pushes B transitions into per step.
  * ``PrioritizedReplayState`` + ``per_init/push/sample/update`` —
    proportional prioritized experience replay (Schaul et al. 2016) on a
    **sum-tree of device tensors**: leaf ``i`` holds ``(|td_i| + eps)**alpha``,
    internal nodes hold subtree sums, and sampling descends the tree in a
    fixed ``log2(L)`` steps for the whole batch at once.

Differences from the reference, all deliberate:

  * The cursor ``ptr`` and the fill ``size`` are host integers.  Their
    values depend only on how many pushes were made, so the training loop's
    update gate (``size >= batch_size``) needs no device sync.
  * Buffers and the tree are written in place (JAX's arrays are immutable;
    here the ring is the largest tensor of a training run and is never
    copied).  Every function still returns the state it was given, updated.
  * Every sampler takes its random numbers as an argument (``idx`` for the
    uniform ring, ``u`` for the stratified PER draw) or draws them from a
    ``torch.Generator``, so a test can feed both packages the same draws.
  * Actions are stored as int64, the index type of ``torch.gather``.

**Sum-tree invariants** (those of the reference).  The tree is a flat
``(2L,)`` f32 tensor over ``L = next_pow2(capacity)`` leaves: node ``i``'s
children are ``2i`` and ``2i + 1``, leaves occupy ``[L, 2L)``, node 1 is the
root.  Every internal node equals the f32 sum of its two children: a write
recomputes each touched leaf's ancestors level by level, bottom-up, as
``tree[2k] + tree[2k + 1]`` (:func:`_tree_ascend`), the same additions in the
same order as the reference, so the f32 trees are bit-equal after the same
pushes, and after updates that write the same leaf priorities (f32 ``pow``
may round a priority's last bit differently in the two packages).  Leaves past ``capacity`` hold 0 and are never reached
by the descent.  Leaf priorities are ``(|td| + eps)**alpha`` with
``eps > 0``, so a stored transition has positive mass.

``ReplayBuffer`` / ``PrioritizedReplayBuffer`` are the numpy stores of the
scalar reference loop, copied as they are (identical tree layout).

Sampling an **empty** ring is undefined; every sampler asserts.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FIELDS = ("s", "a", "r", "s2", "done", "mask2")


class ReplayState(NamedTuple):
    """Ring buffer contents (device tensors) + host cursor and fill."""

    s: torch.Tensor                  # (C, state_dim) f32
    a: torch.Tensor                  # (C,) int64
    r: torch.Tensor                  # (C,) f32
    s2: torch.Tensor                 # (C, state_dim) f32
    done: torch.Tensor               # (C,) f32
    mask2: torch.Tensor              # (C, n_actions) bool
    ptr: int                         # next write slot
    size: int                        # filled entries (<= C)

    @property
    def capacity(self) -> int:
        return self.a.shape[0]


def replay_init(capacity: int, state_dim: int, n_actions: int,
                device: str | torch.device = "cuda") -> ReplayState:
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ReplayState(
        s=z((capacity, state_dim), torch.float32), a=z((capacity,), torch.int64),
        r=z((capacity,), torch.float32), s2=z((capacity, state_dim), torch.float32),
        done=z((capacity,), torch.float32), mask2=z((capacity, n_actions), torch.bool),
        ptr=0, size=0)


def replay_push(rs: ReplayState, batch: dict) -> ReplayState:
    """Write B transitions at the cursor, in place; returns the advanced state.

    Contract (the reference's): every push to a ring uses the same block
    size, and it divides the capacity, so a block never wraps."""
    cap = rs.capacity
    n = batch["a"].shape[0]
    assert cap % n == 0, f"push size {n} must divide capacity {cap}"
    assert rs.ptr % n == 0, (
        f"cursor {rs.ptr} not aligned to push size {n} — all pushes to a ring "
        "must use one block size")
    for f in FIELDS:
        buf = getattr(rs, f)
        buf[rs.ptr:rs.ptr + n] = batch[f]
    return rs._replace(ptr=(rs.ptr + n) % cap, size=min(rs.size + n, cap))


def _assert_nonempty(size: int) -> None:
    assert size > 0, ("replay sample on an empty ring — push transitions first "
                      "or gate on `size` (the training loop's warmup gate)")


def _uniform_indices(size: int, n: int, device, generator: torch.Generator | None
                     ) -> torch.Tensor:
    return torch.randint(0, max(size, 1), (n,), generator=generator, device=device)


def replay_sample(rs: ReplayState, n: int, *, idx: torch.Tensor | None = None,
                  generator: torch.Generator | None = None) -> dict:
    """Uniform sample of n transitions from the filled region: the given
    indices ``idx``, or ``n`` draws from ``generator``."""
    _assert_nonempty(rs.size)
    if idx is None:
        idx = _uniform_indices(rs.size, n, rs.a.device, generator)
    idx = torch.as_tensor(idx, device=rs.a.device).long()
    return {f: getattr(rs, f)[idx] for f in FIELDS}


# ---------------------------------------------------------------------------
# Prioritized replay: sum-tree over the same ring
# ---------------------------------------------------------------------------

def _leaf_count(capacity: int) -> int:
    """Leaves of the complete binary tree: next power of two >= capacity."""
    return 1 << max(0, capacity - 1).bit_length()


class PrioritizedReplayState(NamedTuple):
    """Uniform ring + sum-tree priorities (``tree[1]`` is the total mass,
    ``tree[0]`` unused, leaf ``i`` at ``L + i``)."""

    ring: ReplayState
    tree: torch.Tensor               # (2 * L,) f32 — sum-tree nodes
    max_p: torch.Tensor              # () f32 — running max leaf priority

    @property
    def capacity(self) -> int:
        return self.ring.capacity

    @property
    def ptr(self) -> int:
        return self.ring.ptr

    @property
    def size(self) -> int:
        return self.ring.size


def per_init(capacity: int, state_dim: int, n_actions: int,
             device: str | torch.device = "cuda") -> PrioritizedReplayState:
    return PrioritizedReplayState(
        ring=replay_init(capacity, state_dim, n_actions, device),
        tree=torch.zeros((2 * _leaf_count(capacity),), dtype=torch.float32, device=device),
        max_p=torch.ones((), dtype=torch.float32, device=device),
    )


def _tree_rebuild(tree: torch.Tensor) -> torch.Tensor:
    """Every internal node recomputed from the leaves, level by level (a new
    tensor).  Not on the hot path: the reference the incremental
    :func:`_tree_ascend` is pinned against."""
    level = tree[tree.shape[0] // 2:]
    levels = [level]
    while level.shape[0] > 1:
        level = level.reshape(-1, 2).sum(dim=1)
        levels.append(level)
    return torch.cat([torch.zeros((1,), dtype=tree.dtype, device=tree.device)] + levels[::-1])


def _tree_depth(tree: torch.Tensor) -> int:
    return max(0, (tree.shape[0] // 2).bit_length() - 1)


def _tree_ascend(tree: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Recompute, in place, the ancestors of the leaves at absolute positions
    ``pos``, one level at a time bottom-up.  Each level gathers both children
    before it writes, so parents shared by several touched leaves get the
    same value from each.  Returns ``tree``."""
    k = pos.long()
    for _ in range(_tree_depth(tree)):
        k = k // 2
        tree[k] = tree[2 * k] + tree[2 * k + 1]
    return tree


def _tree_query(tree: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched sum-tree descent: prefix-sum targets ``v`` -> leaf indices.

    Goes right only when the right subtree still has mass, so round-off at a
    segment boundary cannot walk into the zero-padded tail."""
    L = tree.shape[0] // 2
    k = torch.ones(v.shape, dtype=torch.int64, device=v.device)
    for _ in range(_tree_depth(tree)):
        left = tree[2 * k]
        go_right = (v >= left) & (tree[2 * k + 1] > 0)
        k = 2 * k + go_right.long()
        v = v - torch.where(go_right, left, torch.zeros_like(left))
    return k - L


def per_push(ps: PrioritizedReplayState, batch: dict) -> PrioritizedReplayState:
    """Ring push (same block contract as :func:`replay_push`); the new block
    enters at the running max priority so fresh transitions are seen at
    least once before TD errors re-rank them."""
    n = batch["a"].shape[0]
    L = ps.tree.shape[0] // 2
    start = L + ps.ring.ptr
    ps.tree[start:start + n] = ps.max_p
    pos = torch.arange(start, start + n, device=ps.tree.device)
    ring = replay_push(ps.ring, batch)
    return PrioritizedReplayState(ring=ring, tree=_tree_ascend(ps.tree, pos), max_p=ps.max_p)


def per_sample(ps: PrioritizedReplayState, n: int, alpha: float, beta: float, *,
               u: torch.Tensor | None = None, generator: torch.Generator | None = None
               ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """Stratified proportional sample -> (batch, indices, IS weights).

    ``alpha == 0`` is the uniform ring's draw from ``generator``, with unit
    weights.  Otherwise sample ``i`` takes the leaf at
    prefix mass ``(i + u_i) * total / n`` (``u``: n uniforms in [0, 1), given
    or drawn), and its weight is ``(size * P(i)) ** -beta`` normalized so the
    largest sampled weight is exactly 1."""
    _assert_nonempty(ps.ring.size)
    dev = ps.tree.device
    if alpha == 0.0:
        idx = _uniform_indices(ps.ring.size, n, dev, generator)
        w = torch.ones((n,), dtype=torch.float32, device=dev)
    else:
        L = ps.tree.shape[0] // 2
        total = ps.tree[1]
        if u is None:
            u = torch.rand((n,), generator=generator, device=dev)
        u = torch.as_tensor(u, dtype=torch.float32, device=dev)
        targets = (torch.arange(n, dtype=torch.float32, device=dev) + u) * (total / n)
        idx = _tree_query(ps.tree, targets).clamp_max(max(ps.ring.size, 1) - 1)
        probs = ps.tree[L + idx] / total.clamp_min(1e-30)
        w = (float(max(ps.ring.size, 1)) * probs.clamp_min(1e-30)) ** (-beta)
        w = w / w.max()
    batch = {f: getattr(ps.ring, f)[idx] for f in FIELDS}
    return batch, idx, w


def per_update(ps: PrioritizedReplayState, idx: torch.Tensor, td_err: torch.Tensor,
               alpha: float, eps: float) -> PrioritizedReplayState:
    """Re-rank sampled leaves from TD error: ``p = (|td| + eps) ** alpha``.

    Duplicate indices carry identical TD errors (same transition, same
    params), so the scatter is deterministic in effect."""
    p = ((td_err.abs() + eps) ** alpha).float()
    L = ps.tree.shape[0] // 2
    pos = L + idx.long()
    ps.tree[pos] = p
    tree = _tree_ascend(ps.tree, pos)
    return ps._replace(tree=tree, max_p=torch.maximum(ps.max_p, p.max()))


# ---------------------------------------------------------------------------
# numpy stores of the scalar reference loop (copied)
# ---------------------------------------------------------------------------

class ReplayBuffer:
    """Uniform replay (numpy circular store) for the scalar training loop."""

    def __init__(self, capacity: int, state_dim: int, n_actions: int, seed: int = 0):
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a = np.zeros((capacity,), np.int32)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, state_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.mask2 = np.zeros((capacity, n_actions), bool)
        self.ptr = 0
        self.full = False

    def push(self, s, a, r, s2, done, mask2) -> None:
        i = self.ptr
        self.s[i], self.a[i], self.r[i] = s, a, r
        self.s2[i], self.done[i], self.mask2[i] = s2, float(done), mask2
        self.ptr = (self.ptr + 1) % self.capacity
        self.full = self.full or self.ptr == 0

    def __len__(self) -> int:
        return self.capacity if self.full else self.ptr

    def sample(self, batch: int) -> dict:
        assert len(self) > 0, "sample from an empty replay buffer"
        idx = self.rng.integers(0, len(self), size=batch)
        return {
            "s": self.s[idx], "a": self.a[idx], "r": self.r[idx],
            "s2": self.s2[idx], "done": self.done[idx], "mask2": self.mask2[idx],
        }


class PrioritizedReplayBuffer(ReplayBuffer):
    """Numpy mirror of the sum-tree PER (identical tree layout).

    ``sample`` returns ``(batch, indices, IS weights)``; priorities update
    per-leaf with an ancestor walk (the scalar loop pushes one transition at
    a time, so incremental updates beat full rebuilds here).
    """

    def __init__(self, capacity: int, state_dim: int, n_actions: int,
                 seed: int = 0, alpha: float = 0.6, eps: float = 1e-3):
        super().__init__(capacity, state_dim, n_actions, seed)
        self.alpha = alpha
        self.eps = eps
        self.leaves = _leaf_count(capacity)
        self.tree = np.zeros((2 * self.leaves,), np.float64)
        self.max_p = 1.0

    def _set(self, idx, priorities) -> None:
        for i, p in zip(np.atleast_1d(idx), np.atleast_1d(priorities)):
            j = self.leaves + int(i)
            self.tree[j] = p
            j //= 2
            while j >= 1:
                self.tree[j] = self.tree[2 * j] + self.tree[2 * j + 1]
                j //= 2

    def push(self, s, a, r, s2, done, mask2) -> None:
        i = self.ptr
        super().push(s, a, r, s2, done, mask2)
        self._set(i, self.max_p)

    def _query(self, v: float) -> int:
        k = 1
        while k < self.leaves:
            left = self.tree[2 * k]
            if v >= left and self.tree[2 * k + 1] > 0:
                v -= left
                k = 2 * k + 1
            else:
                k = 2 * k
        return k - self.leaves

    def sample(self, batch: int, beta: float = 0.4):
        assert len(self) > 0, "sample from an empty replay buffer"
        if self.alpha == 0.0:
            idx = self.rng.integers(0, len(self), size=batch)
            w = np.ones(batch, np.float32)
        else:
            total = self.tree[1]
            u = self.rng.uniform(size=batch)
            targets = (np.arange(batch) + u) * (total / batch)
            idx = np.array([self._query(t) for t in targets], np.int64)
            idx = np.minimum(idx, len(self) - 1)
            probs = self.tree[self.leaves + idx] / max(total, 1e-30)
            w = (len(self) * np.maximum(probs, 1e-30)) ** (-beta)
            w = (w / w.max()).astype(np.float32)
        out = {
            "s": self.s[idx], "a": self.a[idx], "r": self.r[idx],
            "s2": self.s2[idx], "done": self.done[idx], "mask2": self.mask2[idx],
        }
        return out, idx, w

    def update_priorities(self, idx, td_err) -> None:
        p = (np.abs(np.asarray(td_err, np.float64)) + self.eps) ** self.alpha
        self._set(idx, p)
        self.max_p = max(self.max_p, float(p.max()))
