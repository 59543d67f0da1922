"""Weights carried across from the JAX package.

Both packages keep parameters as nested dicts with the same keys, and the
dense model's layer parameters stacked on a leading ``L`` axis (the
reference's vmapped init), so conversion is a leaf-by-leaf copy.  Inputs
are numpy trees (``jax.device_get`` of the reference's params); a bfloat16
leaf arrives as an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
refuses, so every leaf goes through float32 (exact for bfloat16) and is
cast to its own dtype on the way in.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.agent import DQNAgent

_TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# the reference DQN's leaves in JAX tree order (sorted dict keys)
DQN_KEYS = ("b0", "b1", "b2", "bA", "bV", "w0", "w1", "w2", "wA", "wV")


def _leaf(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    src = np.ascontiguousarray(arr.astype(np.float32))
    return torch.from_numpy(src).to(device=device, dtype=_TORCH_DTYPE[str(arr.dtype)])


def model_params_from_jax(np_tree: dict, cfg, device="cuda") -> dict:
    """The reference model's params (numpy leaves) as the port's params."""
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is not ported yet")
    return {k: model_params_from_jax(v, cfg, device) if isinstance(v, dict) else _leaf(v, device)
            for k, v in np_tree.items()}


def dqn_params_from_numpy(d: dict, device="cuda") -> dict:
    """A DQN params dict of numpy arrays as float32 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v, np.float32).copy()).to(device) for k, v in d.items()}


GOLDEN_WINDOW = 4   # EnvConfig(window=4) of the golden agent: 48 inputs, 25 actions


def load_golden_dqn(path, device="cuda") -> DQNAgent:
    """The trained agent of ``tests/golden/train_agent_proxy_v1.npz``:
    ``param_0..9`` are the leaves :data:`DQN_KEYS` in that order, for an
    ``EnvConfig(window=GOLDEN_WINDOW)`` environment."""
    with np.load(path) as z:
        params = dqn_params_from_numpy({k: z[f"param_{i}"] for i, k in enumerate(DQN_KEYS)},
                                       device)
    state_dim, n_actions = params["w0"].shape[0], params["wA"].shape[1]
    return DQNAgent(state_dim, n_actions, device=device, params=params)
