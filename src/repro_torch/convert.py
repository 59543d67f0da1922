"""Weights and agent state carried across from the JAX package.

Both packages keep parameters as nested dicts with the same keys, and the
layers stacked on a leading axis (the reference's vmapped init: the dense,
MoE and vlm models' ``layers/...``, the Jamba model's
``blocks/sub{i}/...``, the xLSTM model's ``pairs/mlstm/...`` and
``pairs/slstm/...``), so conversion is a leaf-by-leaf copy; the same
holds for the model's AdamW state.  A DQN
agent carries its online and target parameters and its Adam state
(``m``, ``v``, ``t``), so training continues across the packages.  Inputs
are numpy trees (``jax.device_get`` of the reference's params); a bfloat16
leaf arrives as an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
refuses, so every leaf goes through float32 (exact for bfloat16) and is
cast to its own dtype on the way in.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.agent import DQNAgent, DQNConfig
from repro_torch.models.model import require_ported

_TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# the reference DQN's leaves in JAX tree order (sorted dict keys)
DQN_KEYS = ("b0", "b1", "b2", "bA", "bV", "w0", "w1", "w2", "wA", "wV")


def _leaf(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    src = np.ascontiguousarray(arr.astype(np.float32))
    return torch.from_numpy(src).to(device=device, dtype=_TORCH_DTYPE[str(arr.dtype)])


def model_params_from_jax(np_tree: dict, cfg, device="cuda") -> dict:
    """The reference model's params (numpy leaves) as the port's params."""
    require_ported(cfg)
    return {k: model_params_from_jax(v, cfg, device) if isinstance(v, dict) else _leaf(v, device)
            for k, v in np_tree.items()}


def opt_state_from_jax(np_tree: dict, cfg, device="cuda") -> dict:
    """The reference's AdamW state (``jax.device_get`` of ``init_opt_state``
    or ``adamw_update``'s result) as the port's: f32 ``master``, ``m`` and
    ``v`` trees and the int32 step ``count``."""
    out = {k: model_params_from_jax(np_tree[k], cfg, device) for k in ("master", "m", "v")}
    out["count"] = torch.tensor(int(np.asarray(np_tree["count"])), dtype=torch.int32,
                                device=device)
    return out


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
    return DQNAgent(state_dim, n_actions, DQNConfig(), device=device, params=params)


def dqn_agent_from_numpy(params: dict, target: dict | None = None, opt: dict | None = None, *,
                         cfg: DQNConfig | None = None, seed: int = 0, device="cuda",
                         **agent_kwargs) -> DQNAgent:
    """A reference agent's state as a port :class:`DQNAgent` on ``device``.

    ``params`` and ``target`` are numpy trees of the online and target
    networks (``jax.device_get(agent.params)``, ``agent.target_params``),
    ``opt`` the Adam state ``{"m": tree, "v": tree, "t": step}``.  Without
    ``target`` the target network is a copy of ``params``; without ``opt`` the
    Adam state starts at zero.  ``seed`` seeds the agent's numpy streams
    (exploration, replay) as in the reference."""
    p = dqn_params_from_numpy(params, device)
    agent = DQNAgent(p["w0"].shape[0], p["wA"].shape[1], cfg, seed, device=device, params=p,
                     **agent_kwargs)
    if target is not None:
        agent.target_params = dqn_params_from_numpy(target, device)
    if opt is not None:
        agent.opt = {"m": dqn_params_from_numpy(opt["m"], device),
                     "v": dqn_params_from_numpy(opt["v"], device),
                     "t": torch.tensor(int(np.asarray(opt["t"])), dtype=torch.int32,
                                       device=device)}
    return agent
