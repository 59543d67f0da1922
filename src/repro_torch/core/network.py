"""Dueling double deep Q-network in PyTorch (paper §IV-D / Table VI).

Port of ``repro/core/network.py``.  Parameters stay the same flat
key -> tensor dict as the reference (``w0..w2, b0..b2, wV, bV, wA, bA``),
so weights move between the two packages leaf for leaf
(:mod:`repro_torch.convert`).

Architecture: 3 fully-connected hidden layers 512/256/128 with ReLU,
dueling heads V (1) and A (n_actions), Q = V + A - mean(A).

Float32 products on the card must not go through TF32: ``DQNAgent`` pins
``torch.backends.cuda.matmul.allow_tf32 = False`` so Q-values, and with
them the greedy actions, agree with the reference to f32 rounding.
"""
from __future__ import annotations

import torch

HIDDEN = (512, 256, 128)


def init_dqn(generator: torch.Generator, in_dim: int, n_actions: int, hidden=HIDDEN,
             device: str | torch.device = "cuda") -> dict:
    """He-normal hidden layers and 1/sqrt(fan_in) heads, biases zero.

    ``generator`` draws on the CPU; the tensors then move to ``device``, so
    one seed gives the same weights on every device."""
    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).to(device)

    params = {}
    dims = (in_dim, *hidden)
    for i in range(len(hidden)):
        params[f"w{i}"] = normal((dims[i], dims[i + 1]), (2.0 / dims[i]) ** 0.5)
        params[f"b{i}"] = torch.zeros(dims[i + 1], device=device)
    params["wV"] = normal((hidden[-1], 1), (1.0 / hidden[-1]) ** 0.5)
    params["bV"] = torch.zeros(1, device=device)
    params["wA"] = normal((hidden[-1], n_actions), (1.0 / hidden[-1]) ** 0.5)
    params["bA"] = torch.zeros(n_actions, device=device)
    return params


def dqn_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (..., in_dim) -> Q (..., n_actions)."""
    h = x
    i = 0
    while f"w{i}" in params:
        h = torch.relu(h @ params[f"w{i}"] + params[f"b{i}"])
        i += 1
    v = h @ params["wV"] + params["bV"]                    # (..., 1)
    a = h @ params["wA"] + params["bA"]                    # (..., n_actions)
    return v + a - a.mean(dim=-1, keepdim=True)


def masked_argmax(q: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Argmax over the valid actions; among equal maxima the first index wins
    (``torch.argmax`` leaves ties unspecified, ``jnp.argmax`` does not)."""
    qm = torch.where(mask, q, torch.full_like(q, -torch.inf))
    best = qm.max(dim=-1, keepdim=True).values
    idx = torch.arange(q.shape[-1], device=q.device).expand_as(q)
    big = torch.full_like(idx, q.shape[-1])
    return torch.where(qm == best, idx, big).min(dim=-1).values


def greedy_q_action(params: dict, obs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Greedy fit-masked action for one observation: () int32."""
    q = dqn_apply(params, obs[None])[0]
    return masked_argmax(q, mask).to(torch.int32)


def widen_dqn_params(params: dict, extra_in: int) -> dict:
    """Zero-pad the input layer for ``extra_in`` appended observation dims,
    so the widened network computes the same Q-values at zero context."""
    assert extra_in >= 0, extra_in
    out = dict(params)
    w0 = params["w0"]
    pad = torch.zeros((extra_in, w0.shape[1]), dtype=w0.dtype, device=w0.device)
    out["w0"] = torch.cat([w0, pad], dim=0)
    return out
