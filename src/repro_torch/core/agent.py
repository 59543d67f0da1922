"""DQN agent, the inference part: greedy masked action selection.

Port of the serving half of ``repro/core/agent.py``.  ``DQNAgent`` holds
the online parameters on a device and answers ``act(state, mask,
greedy=True)`` through :func:`~repro_torch.core.network.greedy_q_action`,
the one action-selection implementation.  Exploration, replay, the
double-DQN update and their settings (the reference's ``DQNConfig``) belong
to the training side of the reference and are not part of this package yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.network import greedy_q_action, init_dqn


class DQNAgent:
    """Greedy DQN policy on ``device`` (the card unless the caller asks for
    the CPU)."""

    def __init__(self, state_dim: int, n_actions: int, seed: int = 0,
                 device: str | torch.device = "cuda", params: dict | None = None):
        # f32 Q-values must not be rounded through TF32 on the card: a
        # near-tie between two actions would flip against the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        self.device = torch.device(device)
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            params = init_dqn(gen, state_dim, n_actions, device=self.device)
        else:
            params = {k: v.to(self.device, torch.float32) for k, v in params.items()}
            assert params["w0"].shape[0] == state_dim, (params["w0"].shape, state_dim)
            assert params["wA"].shape[1] == n_actions, (params["wA"].shape, n_actions)
        self.params = params

    def act(self, state: np.ndarray, mask: np.ndarray, greedy: bool = True) -> int:
        if not greedy:
            raise NotImplementedError("exploration is part of DQN training, "
                                      "which this package does not port yet")
        obs = torch.as_tensor(np.asarray(state, np.float32), device=self.device)
        m = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        return int(greedy_q_action(self.params, obs, m))
