"""DQN agent: masked ε-greedy action selection + double-DQN updates.

Port of ``repro/core/agent.py``.  Two call surfaces share the same
parameters and update rule:

  * ``DQNAgent`` — the stateful single-env agent used by ``RLScheduler`` and
    the scalar training loop, on a device (the card unless the caller asks
    for the CPU).  Greedy (evaluation) calls do **not** advance
    ``env_steps``, so evaluation frequency cannot perturb the ε schedule;
    exploration draws from the agent's numpy ``rng`` as the reference does.
  * ``act_batch`` / ``epsilon_at`` — functions over (params, obs, mask) used
    by the batched training loop: masked ε-greedy selection for B envs at
    once, with the Bernoulli uniforms and the choice scores passed in or
    drawn from a ``torch.Generator``.

Gradients come from autograd.  The optimizer is the reference's hand-rolled
Adam (:func:`_adam_step`), which folds the bias correction into the step
size and adds eps to ``sqrt(v)``; ``torch.optim.Adam`` places eps
differently, so it is not used.  Float32 products on the card must not go
through TF32: ``DQNAgent`` turns it off, for its forward passes and its
updates alike.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.network import dqn_apply, greedy_q_action, init_dqn, masked_argmax
from repro_torch.core.replay import PrioritizedReplayBuffer, ReplayBuffer


@dataclass(frozen=True)
class DQNConfig:
    gamma: float = 0.99
    lr: float = 5e-4
    batch_size: int = 128
    buffer_size: int = 100_000
    target_sync: int = 500           # updates between target-network syncs
    eps_start: float = 1.0
    eps_end: float = 0.01
    eps_decay_steps: int = 15_000    # env steps for linear ε decay
    huber_delta: float = 1.0
    reward_scale: float = 0.01       # rewards are O(100); keep TD targets O(1)


def _adam_init(params: dict) -> dict:
    any_leaf = next(iter(params.values()))
    return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()},
            "t": torch.zeros((), dtype=torch.int32, device=any_leaf.device)}


def _td_and_huber(p: dict, target_params: dict, batch: dict, cfg: DQNConfig):
    """Per-sample double-DQN TD error and its Huber transform."""
    q = dqn_apply(p, batch["s"])                                       # (B, A)
    q_sa = q.gather(1, batch["a"].long()[:, None])[:, 0]
    with torch.no_grad():
        # double DQN: online argmax (masked), target value; the target y
        # carries no gradient (the reference's stop_gradient)
        a2 = masked_argmax(dqn_apply(p, batch["s2"]), batch["mask2"])
        v2 = dqn_apply(target_params, batch["s2"]).gather(1, a2[:, None])[:, 0]
        v2 = torch.where(batch["mask2"].any(dim=1), v2, 0.0)          # terminal: no actions
        y = batch["r"] * cfg.reward_scale + cfg.gamma * (1.0 - batch["done"]) * v2
    err = q_sa - y
    abs_err = err.abs()
    huber = torch.where(abs_err <= cfg.huber_delta, 0.5 * err ** 2,
                        cfg.huber_delta * (abs_err - 0.5 * cfg.huber_delta))
    return err, huber


def _adam_step(params: dict, grads: dict, opt: dict, lr: float):
    """One Adam step; new tensors, the inputs are left as they were."""
    keys = list(params)
    b1, b2, eps = 0.9, 0.999, 1e-8
    g = [grads[k] for k in keys]
    t = opt["t"] + 1
    m = torch._foreach_mul([opt["m"][k] for k in keys], b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    v = torch._foreach_mul([opt["v"][k] for k in keys], b2)
    g2 = torch._foreach_mul(g, 1 - b2)
    torch._foreach_mul_(g2, g)
    torch._foreach_add_(v, g2)
    tf = t.float()
    lr_t = lr * torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
    den = torch._foreach_sqrt(v)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_mul(m, lr_t)
    torch._foreach_div_(upd, den)
    new = torch._foreach_sub([params[k] for k in keys], upd)
    return dict(zip(keys, new)), {"m": dict(zip(keys, m)), "v": dict(zip(keys, v)), "t": t}


def _loss_grads(params: dict, target_params: dict, batch: dict, cfg: DQNConfig,
                w: torch.Tensor | None = None):
    """(loss, TD errors, gradients) of the (importance-weighted) mean Huber
    loss at ``params``.  With ``w`` all ones the loss is bit-equal to the
    unweighted one."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        err, huber = _td_and_huber(p, target_params, batch, cfg)
        loss = (huber if w is None else w * huber).mean()
        grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), err.detach(), dict(zip(p, grads))


def _grad_norm(grads: dict) -> torch.Tensor:
    """Global L2 norm over all gradient leaves (training telemetry)."""
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


def _dqn_update(params, target_params, opt, batch, cfg: DQNConfig):
    """Double-DQN update -> (params, opt, loss)."""
    loss, _, grads = _loss_grads(params, target_params, batch, cfg)
    params, opt = _adam_step(params, grads, opt, cfg.lr)
    return params, opt, loss


def _dqn_update_aux(params, target_params, opt, batch, cfg: DQNConfig):
    """``_dqn_update`` + telemetry -> (params, opt, loss, mean |td|, grad norm);
    the same parameter trajectory."""
    loss, err, grads = _loss_grads(params, target_params, batch, cfg)
    gnorm = _grad_norm(grads)
    params, opt = _adam_step(params, grads, opt, cfg.lr)
    return params, opt, loss, err.abs().mean(), gnorm


def _dqn_update_per(params, target_params, opt, batch, w, cfg: DQNConfig):
    """Importance-weighted double-DQN update -> (params, opt, loss, |td|).

    ``w`` are the prioritized sampler's per-sample IS weights; the returned
    absolute TD errors feed the sum-tree priority refresh.  With ``w == 1``
    this is bit-equal to :func:`_dqn_update`."""
    loss, err, grads = _loss_grads(params, target_params, batch, cfg, w)
    params, opt = _adam_step(params, grads, opt, cfg.lr)
    return params, opt, loss, err.abs()


def _dqn_update_per_aux(params, target_params, opt, batch, w, cfg: DQNConfig):
    """``_dqn_update_per`` + grad-norm -> (params, opt, loss, |td|, grad norm)."""
    loss, err, grads = _loss_grads(params, target_params, batch, cfg, w)
    gnorm = _grad_norm(grads)
    params, opt = _adam_step(params, grads, opt, cfg.lr)
    return params, opt, loss, err.abs(), gnorm


def epsilon_at(cfg: DQNConfig, env_steps: int) -> float:
    """Linear ε schedule as a function of the env-step count (a host int in
    the port: the training loop keeps its counters on the host)."""
    frac = min(1.0, env_steps / max(1, cfg.eps_decay_steps))
    return cfg.eps_start + (cfg.eps_end - cfg.eps_start) * frac


def beta_at(beta0: float, env_steps: int, decay_steps: int) -> float:
    """Linear IS-exponent anneal β0 -> 1 over the ε-decay horizon."""
    frac = min(1.0, env_steps / max(1, decay_steps))
    return beta0 + (1.0 - beta0) * frac


def act_batch(params: dict, obs: torch.Tensor, mask: torch.Tensor, eps: float, *,
              u: torch.Tensor | None = None, scores: torch.Tensor | None = None,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Masked ε-greedy for B envs: obs (B, D), mask (B, A) -> (B,) int64.

    Env b explores when ``u[b] < eps``, and then takes the valid action of
    largest score ``scores[b]`` (a uniformly random valid action).  ``u``
    (B,) and ``scores`` (B, A), uniforms in [0, 1), are drawn from
    ``generator`` when not given."""
    with torch.no_grad():
        greedy = masked_argmax(dqn_apply(params, obs), mask)
    if u is None:
        u = torch.rand(greedy.shape, generator=generator, device=obs.device)
    if scores is None:
        scores = torch.rand(mask.shape, generator=generator, device=obs.device)
    rand = torch.argmax(torch.where(mask, scores, -1.0), dim=-1)
    return torch.where(u < eps, rand, greedy)


class DQNAgent:
    """DQN agent on ``device`` (the card unless the caller asks for the CPU).

    ``params`` (optional) are the online parameters to start from; the
    target network starts as a copy of them and the Adam state at zero."""

    def __init__(self, state_dim: int, n_actions: int, cfg: DQNConfig | None = None,
                 seed: int = 0, per_alpha: float = 0.0, per_beta0: float = 0.4,
                 per_eps: float = 1e-3, *, device: str | torch.device = "cuda",
                 params: dict | None = None):
        # f32 Q-values and gradients must not be rounded through TF32 on the
        # card: a near-tie between two actions would flip against the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg or DQNConfig()
        self.device = torch.device(device)
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            params = init_dqn(gen, state_dim, n_actions, device=self.device)
        else:
            params = {k: v.to(self.device, torch.float32) for k, v in params.items()}
            assert params["w0"].shape[0] == state_dim, (params["w0"].shape, state_dim)
            assert params["wA"].shape[1] == n_actions, (params["wA"].shape, n_actions)
        self.params = params
        self.target_params = {k: v.clone() for k, v in params.items()}
        self.opt = _adam_init(params)
        self._replay: ReplayBuffer | None = None   # lazy: ~100 MB at defaults
        self._replay_shape = (state_dim, n_actions, seed)
        self.per_alpha = per_alpha                 # 0 -> uniform replay
        self.per_beta0 = per_beta0
        self.per_eps = per_eps
        self.rng = np.random.default_rng(seed)
        self.env_steps = 0
        self.updates = 0

    def load_state(self, src: "DQNAgent") -> None:
        """Copy ``src``'s params, target params and Adam state onto this
        agent's device (copies: the two agents share no tensor)."""
        def cp(tree):
            return {k: v.to(self.device).clone() for k, v in tree.items()}

        self.params, self.target_params = cp(src.params), cp(src.target_params)
        self.opt = {"m": cp(src.opt["m"]), "v": cp(src.opt["v"]),
                    "t": src.opt["t"].to(self.device).clone()}

    @property
    def replay(self) -> ReplayBuffer:
        """Numpy replay for the scalar loop; the batched loop keeps its own
        ring on the device, so allocation waits for first use."""
        if self._replay is None:
            d, a, seed = self._replay_shape
            if self.per_alpha > 0:
                self._replay = PrioritizedReplayBuffer(
                    self.cfg.buffer_size, d, a, seed,
                    alpha=self.per_alpha, eps=self.per_eps)
            else:
                self._replay = ReplayBuffer(self.cfg.buffer_size, d, a, seed)
        return self._replay

    # ----------------------------------------------------------------- act
    @property
    def epsilon(self) -> float:
        return epsilon_at(self.cfg, self.env_steps)

    def act(self, state: np.ndarray, mask: np.ndarray, greedy: bool = False) -> int:
        if not greedy:
            # only exploration steps advance the ε-decay schedule; greedy
            # (evaluation) calls must not change exploration behaviour
            self.env_steps += 1
            if self.rng.random() < self.epsilon:
                return int(self.rng.choice(np.flatnonzero(mask)))
        obs = torch.as_tensor(np.asarray(state, np.float32), device=self.device)
        m = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        return int(greedy_q_action(self.params, obs, m))

    # -------------------------------------------------------------- learn
    def observe(self, s, a, r, s2, done, mask2) -> None:
        self.replay.push(s, a, r, s2, done, mask2)

    def _batch(self, batch: dict) -> dict:
        out = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        out["a"] = out["a"].long()
        return out

    def update(self) -> float | None:
        if len(self.replay) < self.cfg.batch_size:
            return None
        if self.per_alpha > 0:
            beta = beta_at(self.per_beta0, self.env_steps, self.cfg.eps_decay_steps)
            batch, idx, w = self.replay.sample(self.cfg.batch_size, beta)
            self.params, self.opt, loss, td = _dqn_update_per(
                self.params, self.target_params, self.opt, self._batch(batch),
                torch.as_tensor(w, device=self.device), self.cfg)
            self.replay.update_priorities(idx, td.cpu().numpy())
        else:
            batch = self.replay.sample(self.cfg.batch_size)
            self.params, self.opt, loss = _dqn_update(
                self.params, self.target_params, self.opt, self._batch(batch), self.cfg)
        self.updates += 1
        if self.updates % self.cfg.target_sync == 0:
            self.target_params = {k: v.clone() for k, v in self.params.items()}
        return float(loss)
