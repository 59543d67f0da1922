"""Offline RL training (paper §IV-B) on a batched engine on the card.

Port of ``repro/core/train.py`` (``train_agent``, ``train_agent_scalar``,
``TrainConfig``, ``heldout_split``; not ``train_online``).

``train_agent`` steps B environments at once.  One engine step is B
transitions: masked ε-greedy actions for all envs (:func:`act_batch`), one
batched environment step whose close rewards come from the batched perfmodel
(``VecCoScheduleEnv.step_batch``), a block push into the replay ring on the
device, and — every ``update_period``-th step once the ring holds
``batch_size`` transitions — ``updates_per_scan`` double-DQN updates, with
the target network synced on the transition cadence.  With
``cfg.per_alpha > 0`` the ring is the sum-tree prioritized buffer: IS
weights with β annealed alongside ε, and |TD|-driven priority refresh.
Finished envs auto-reset to their segment's queue (with a fresh context
under ``obs_context``).  This is the reference's jitted ``lax.scan`` engine
(``_build_engine``) written as a loop: the same per-step work in the same
order.

The step count, the update count and the replay fill are host integers,
whose values follow from the schedule alone, so no gate needs a value from
the device; episode counts and returns accumulate on the device and are read
once per segment.  Segments, evaluation and history records keep the
reference's semantics: a segment of ~``eval_every`` episodes runs B envs on
queues drawn from the 20 training queues; ``episode`` in a record is the
cumulative completed-episode count (it can overshoot ``cfg.episodes`` by up
to one segment), ``ep_reward`` the mean return of the segment's completed
episodes, ``eval_throughput`` the mean greedy relative throughput over the
train queues, and ``heldout_throughput`` the same over queues of held-out
jobs (``None`` when there are none), both from one batched greedy rollout on
the device.

The random streams are ``torch.Generator``s seeded from ``cfg.seed``: a run
is deterministic on one device, but its draws are not JAX's, so this loop is
held to the reference on outcome, and step by step only through
``train_agent_scalar`` (numpy streams shared by both packages).

``train_agent(..., warm_start=agent)`` seeds the engine from an existing
agent's online/target params and optimizer state: exploration restarts at
step 0 under ``cfg.dqn``'s ε schedule, the Q-function continues.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.agent import (
    DQNAgent, DQNConfig, _dqn_update, _dqn_update_aux, _dqn_update_per,
    _dqn_update_per_aux, act_batch, beta_at, epsilon_at,
)
from repro_torch.core.env import CoScheduleEnv, EnvConfig, EnvState, VecCoScheduleEnv
from repro_torch.core.metrics import relative_throughput
from repro_torch.core.network import dqn_apply, masked_argmax
from repro_torch.core.perfmodel_vec import QueueArrays, stack_queues
from repro_torch.core.profiles import JobProfile
from repro_torch.core.replay import (
    per_init, per_push, per_sample, per_update, replay_init, replay_push, replay_sample,
)
from repro_torch.core.scheduler import RLScheduler
from repro_torch.core.workloads import QUEUE_KINDS, make_queue


@dataclass
class TrainConfig:
    episodes: int = 3000
    updates_per_step: int = 1
    n_train_queues: int = 20            # paper: 20 random queues for training
    n_heldout_queues: int = 8           # unseen-job queues per eval record
    strict_classes: bool = True         # demand CI+MI+US in the train pool
    seed: int = 0
    eval_every: int = 100
    batch_envs: int = 16                # B parallel envs in the batched engine
    update_every: int = 16              # env transitions per DQN update
    per_alpha: float = 0.0              # PER priority exponent; 0 = uniform
    per_beta0: float = 0.4              # initial IS-correction exponent
    per_eps: float = 1e-3               # priority floor added to |TD|
    obs_context: bool = False           # arrival-aware context features:
                                        # promotes env_cfg.obs_context and
                                        # samples per-episode contexts
    telemetry: bool = False             # per-record loss/TD/grad-norm series
    dqn: DQNConfig = field(default_factory=DQNConfig)


def heldout_split(jobs: list[JobProfile], frac: float = 0.33, seed: int = 7):
    """Paper: mark ~1/3 of programs as unseen (*) — excluded from training."""
    rng = np.random.default_rng(seed)
    by_cls: dict[str, list[JobProfile]] = {}
    for j in jobs:
        by_cls.setdefault(j.job_class, []).append(j)
    held: set[str] = set()
    for cls, pool in by_cls.items():
        k = max(1, int(len(pool) * frac)) if len(pool) > 1 else 0
        idx = rng.permutation(len(pool))[:k]
        held.update(pool[i].name for i in idx)
    return held


def _train_queues(jobs, env_cfg, cfg, heldout, rng):
    """20 fixed training queues, all classes represented (paper §V-A2);
    ``cfg.strict_classes=False`` lets recipes remap missing classes."""
    return [
        make_queue(jobs, QUEUE_KINDS[i % len(QUEUE_KINDS)], env_cfg.window, rng,
                   exclude=heldout, strict=cfg.strict_classes)
        for i in range(cfg.n_train_queues)
    ]


def _heldout_queues(jobs, env_cfg, cfg, heldout, rng):
    """Queues drawn only from held-out jobs — the generalization eval batch;
    empty when there are no held-out jobs.  Its own RNG keeps the training
    stream untouched."""
    pool = [j for j in jobs if j.name in heldout]
    if not pool or cfg.n_heldout_queues <= 0:
        return []
    return [
        make_queue(pool, QUEUE_KINDS[i % len(QUEUE_KINDS)], env_cfg.window, rng,
                   strict=False)
        for i in range(cfg.n_heldout_queues)
    ]


# ---------------------------------------------------------------------------
# Batched rollout + update engine
# ---------------------------------------------------------------------------

def _bsel(pred: torch.Tensor, a: EnvState, b: EnvState, ctx_mode: bool) -> EnvState:
    """Per-env select of the episode state (pred (B,)).  The queue is the
    same in both within a segment, and so is the context unless contexts are
    resampled, so only what can differ is selected."""
    def sel(x, y):
        return torch.where(pred.reshape(pred.shape + (1,) * (x.dim() - 1)), x, y)

    out = b._replace(scheduled=sel(a.scheduled, b.scheduled),
                     group_idx=sel(a.group_idx, b.group_idx),
                     group_size=sel(a.group_size, b.group_size))
    if ctx_mode:
        out = out._replace(ctx=type(a.ctx)(*(sel(x, y) for x, y in zip(a.ctx, b.ctx))))
    return out


class _Engine:
    """Training state and the per-step work of :func:`train_agent`.

    ``updates_per_scan`` updates run every ``update_period``-th engine step —
    together they honor ``update_every`` whether B is larger or smaller than
    it; ``sync_updates`` is the target-sync period in updates, pre-scaled so
    the target refreshes on the scalar loop's transition cadence.
    ``per = (alpha, beta0, eps)`` selects the prioritized ring."""

    def __init__(self, venv: VecCoScheduleEnv, dqn_cfg: DQNConfig, batch_envs: int,
                 updates_per_scan: int, update_period: int, sync_updates: int,
                 per, telemetry: bool, agent: DQNAgent, generator: torch.Generator):
        self.venv, self.cfg, self.B = venv, dqn_cfg, batch_envs
        self.updates_per_scan, self.update_period = updates_per_scan, update_period
        self.sync_updates, self.per, self.telemetry = sync_updates, per, telemetry
        self.ctx_mode = venv.cfg.obs_context
        self.gen = generator
        self.params, self.target, self.opt = agent.params, agent.target_params, agent.opt
        # round capacity up to a multiple of B: ring writes stay block-aligned
        capacity = -(-dqn_cfg.buffer_size // batch_envs) * batch_envs
        init = replay_init if per is None else per_init
        self.replay = init(capacity, venv.state_dim, venv.n_actions, venv.device)
        self.env_steps = 0
        self.updates = 0
        self.syncs = 0                  # target-network refreshes
        # telemetry: sums over engine steps that ran updates (last update's
        # loss, |td|, grad norm) since the last record, and their count
        self.tel = None
        self.tel_n = 0

    def start_segment(self, qa: QueueArrays, ctx=None):
        """Reset every env onto its queue; ``ctx`` replaces the zero context."""
        venv = self.venv
        if ctx is None:
            r_env, r_obs, r_mask = venv.reset_batch(qa)
        else:
            r_env, r_obs, r_mask = venv.reset_batch_ctx(qa, ctx)
        self.reset = (r_env, r_obs, r_mask)
        self.env, self.obs, self.mask = r_env, r_obs, r_mask
        self.ep_ret = torch.zeros((self.B,), device=venv.device)
        self.n_done = torch.zeros((), dtype=torch.int64, device=venv.device)
        self.ret_sum = torch.zeros((), device=venv.device)

    def _update(self):
        """``updates_per_scan`` gated updates; the telemetry of the last."""
        cfg, per = self.cfg, self.per
        beta = (beta_at(per[1], self.env_steps, cfg.eps_decay_steps)
                if per is not None else None)
        tl = None
        for _ in range(self.updates_per_scan):
            if per is None:
                batch = replay_sample(self.replay, cfg.batch_size, generator=self.gen)
                if self.telemetry:
                    self.params, self.opt, loss, td, gn = _dqn_update_aux(
                        self.params, self.target, self.opt, batch, cfg)
                    tl = (loss, td, gn)
                else:
                    self.params, self.opt, _ = _dqn_update(
                        self.params, self.target, self.opt, batch, cfg)
            else:
                alpha, _, per_eps = per
                batch, idx, w = per_sample(self.replay, cfg.batch_size, alpha, beta,
                                           generator=self.gen)
                if self.telemetry:
                    self.params, self.opt, loss, td, gn = _dqn_update_per_aux(
                        self.params, self.target, self.opt, batch, w, cfg)
                    tl = (loss, td.mean(), gn)
                else:
                    self.params, self.opt, _, td = _dqn_update_per(
                        self.params, self.target, self.opt, batch, w, cfg)
                if alpha > 0:          # alpha == 0: priorities never read
                    self.replay = per_update(self.replay, idx, td, alpha, per_eps)
            self.updates += 1
            if self.updates % self.sync_updates == 0:
                self.target = {k: v.clone() for k, v in self.params.items()}
                self.syncs += 1
        return tl

    def step(self):
        """One engine step: B transitions, then the gated updates."""
        venv, B = self.venv, self.B
        self.env_steps += B
        eps = epsilon_at(self.cfg, self.env_steps)
        a = act_batch(self.params, self.obs, self.mask, eps, generator=self.gen)
        env2, obs2, r, done, mask2 = venv.step_batch(self.env, a)
        push = replay_push if self.per is None else per_push
        self.replay = push(self.replay, {"s": self.obs, "a": a, "r": r, "s2": obs2,
                                         "done": done.float(), "mask2": mask2})
        scan_t = self.env_steps // B                  # 1-based step index
        if self.replay.size >= self.cfg.batch_size and scan_t % self.update_period == 0:
            tl = self._update()
            if tl is not None:
                tl = torch.stack(tl)
                self.tel = tl if self.tel is None else self.tel + tl
                self.tel_n += 1
        ep_all = self.ep_ret + r
        r_env, r_obs, r_mask = self.reset
        if self.ctx_mode:
            # envs that finished an episode restart on a freshly sampled
            # cluster state; the profile prefix of a reset observation does
            # not depend on the context, so only the context tail is new
            fresh = venv.sample_context(self.gen, r_env.queue.mean_d, r_env.queue.valid)
            r_env = r_env._replace(ctx=fresh)
            d0 = venv.state_dim - venv.context_dim
            r_obs = torch.cat([r_obs[:, :d0], fresh.busy_units, fresh.ages,
                               fresh.queue_depth[:, None]], dim=1)
        self.env = _bsel(done, r_env, env2, self.ctx_mode)
        self.obs = torch.where(done[:, None], r_obs, obs2)
        self.mask = torch.where(done[:, None], r_mask, mask2)
        self.ep_ret = torch.where(done, 0.0, ep_all)
        self.n_done += done.sum()
        self.ret_sum += torch.where(done, ep_all, 0.0).sum()


def _engine_for(venv: VecCoScheduleEnv, cfg: TrainConfig, agent: DQNAgent,
                generator: torch.Generator, force_per: bool = False) -> _Engine:
    """The engine :func:`train_agent` runs for ``cfg``, on ``venv``, starting
    from ``agent``'s params, target and optimizer state."""
    B = cfg.batch_envs
    use_per = cfg.per_alpha > 0 or force_per
    per = (cfg.per_alpha, cfg.per_beta0, cfg.per_eps) if use_per else None
    # honor the configured updates-per-transition ratio on both sides of
    # B vs update_every
    ratio = B * cfg.updates_per_step / max(1, cfg.update_every)
    if ratio >= 1.0:
        updates_per_scan, update_period = max(1, round(ratio)), 1
    else:
        updates_per_scan, update_period = 1, max(1, round(1.0 / ratio))
    # keep the target-refresh cadence fixed in env transitions (the scalar
    # loop's 1:1 ratio made target_sync updates == transitions)
    sync_updates = max(1, round(cfg.dqn.target_sync * updates_per_scan
                                / (B * update_period)))
    return _Engine(venv, cfg.dqn, B, updates_per_scan, update_period, sync_updates, per,
                   cfg.telemetry, agent, generator)


def _evaluate(venv: VecCoScheduleEnv, params: dict, qa: QueueArrays) -> np.ndarray:
    """Greedy relative throughput of every queue of ``qa``, one batched
    rollout on the device.

    2W steps bound an episode (W selects + at most W closes); each closed
    group's co-run and solo times come from the batched perfmodel.  A
    multi-job group whose co-run loses to time sharing counts at its solo
    time (``RLScheduler``'s constraint-1 fallback)."""
    env, obs, mask = venv.reset_batch(qa)
    cot = torch.zeros(mask.shape[:1], device=venv.device)
    sol = torch.zeros_like(cot)
    for _ in range(2 * venv.cfg.window):
        a = masked_argmax(dqn_apply(params, obs), mask)
        env, obs, _, _, mask, mk, so, multi = venv.step_batch(env, a, with_metrics=True)
        cot = cot + torch.where(multi & (mk > so), so, mk)
        sol = sol + so
    return torch.where(cot > 0, sol / cot.clamp_min(1e-30), 0.0).cpu().numpy()


@torch.no_grad()
def train_agent(jobs: list[JobProfile], env_cfg: EnvConfig | None = None,
                cfg: TrainConfig | None = None, heldout: set[str] | None = None,
                verbose: bool = False, warm_start: DQNAgent | None = None,
                _force_per: bool = False, *, device: str | torch.device = "cuda",
                on_segment=None) -> tuple[DQNAgent, list[dict]]:
    """Train on the batched engine on ``device``; the reference's signature
    and history records.

    ``cfg.per_alpha > 0`` switches to prioritized replay; ``_force_per``
    routes ``per_alpha == 0`` through the PER machinery anyway (uniform
    indices, unit weights).  ``warm_start`` seeds params/target/opt from an
    existing agent (shapes must match this ``env_cfg``).  ``cfg.obs_context``
    widens observations with the context block and samples a fresh context
    per episode; evaluation stays at the zero context.  ``cfg.telemetry``
    adds ``loss``/``td_abs``/``grad_norm``/``beta``/``updates`` to each
    record.  ``on_segment(steps, seconds)``, when given, is called after each
    segment with its engine steps and wall seconds (the device synchronized).
    """
    cfg = cfg or TrainConfig()
    env_cfg = env_cfg or EnvConfig()
    if cfg.obs_context and not env_cfg.obs_context:
        env_cfg = dataclasses.replace(env_cfg, obs_context=True)
    use_ctx = env_cfg.obs_context
    B = cfg.batch_envs
    use_per = cfg.per_alpha > 0 or _force_per
    venv = VecCoScheduleEnv(env_cfg, device)
    agent = DQNAgent(venv.state_dim, venv.n_actions, cfg.dqn, seed=cfg.seed,
                     per_alpha=cfg.per_alpha, per_beta0=cfg.per_beta0,
                     per_eps=cfg.per_eps, device=device)
    if warm_start is not None:
        src, dst = warm_start.params, agent.params
        assert src.keys() == dst.keys() and all(src[k].shape == dst[k].shape for k in src), \
            "warm_start agent shape mismatch with this EnvConfig/DQNConfig"
        agent.load_state(warm_start)
    rng = np.random.default_rng(cfg.seed)
    heldout = heldout if heldout is not None else heldout_split(jobs)
    train_queues = _train_queues(jobs, env_cfg, cfg, heldout, rng)
    held_queues = _heldout_queues(jobs, env_cfg, cfg, heldout,
                                  np.random.default_rng(cfg.seed + 0x9E37))
    qa_all = venv.queue_batch(train_queues)
    n_tr = len(train_queues)
    # one stacked eval batch: train queues first, held-out queues after
    qa_eval = (stack_queues([venv.queue_arrays(q) for q in train_queues + held_queues])
               if held_queues else qa_all)

    # segment length targeting ~eval_every completed episodes; never below
    # one worst-case episode (2W steps: all-solo groups)
    ep_len = env_cfg.window + math.ceil(env_cfg.window / env_cfg.c_max)
    seg_eps = max(1, min(cfg.eval_every, cfg.episodes))
    seg_steps = max(2 * env_cfg.window, math.ceil(seg_eps * ep_len / B))

    gen = torch.Generator(venv.device).manual_seed(cfg.seed)
    # segment-start contexts draw from their own stream
    ctx_gen = torch.Generator(venv.device).manual_seed(cfg.seed + 0x51C3) if use_ctx else None
    eng = _engine_for(venv, cfg, agent, gen, force_per=_force_per)
    eval_every = max(1, cfg.eval_every)
    episodes_done, next_eval = 0, eval_every
    history: list[dict] = []

    while episodes_done < cfg.episodes:
        t0 = _now(venv.device)
        # each env runs one of the fixed training queues for this segment
        env_q = rng.integers(0, n_tr, size=B)
        idx = torch.as_tensor(env_q, device=venv.device)
        qa_batch = QueueArrays(*(f[idx] for f in qa_all))
        ctx = (venv.sample_context(ctx_gen, qa_batch.mean_d, qa_batch.valid)
               if use_ctx else None)
        eng.start_segment(qa_batch, ctx)
        for _ in range(seg_steps):
            eng.step()
        n_done = int(eng.n_done)
        episodes_done += n_done
        if on_segment is not None:
            on_segment(seg_steps, _now(venv.device) - t0)
        if episodes_done >= next_eval or episodes_done >= cfg.episodes:
            agent.params, agent.target_params, agent.opt = eng.params, eng.target, eng.opt
            agent.env_steps, agent.updates = eng.env_steps, eng.updates
            tp = _evaluate(venv, eng.params, qa_eval)
            rec = {"episode": episodes_done, "eps": agent.epsilon,
                   "ep_reward": float(eng.ret_sum) / max(1, n_done),
                   "eval_throughput": float(tp[:n_tr].mean()),
                   "heldout_throughput": (float(tp[n_tr:].mean())
                                          if held_queues else None)}
            if cfg.telemetry:
                n = eng.tel_n
                sums = eng.tel.tolist() if n else (None, None, None)
                for k, s in zip(("loss", "td_abs", "grad_norm"), sums):
                    rec[k] = s / n if n else None
                rec["beta"] = (beta_at(cfg.per_beta0, eng.env_steps, cfg.dqn.eps_decay_steps)
                               if use_per else None)
                rec["updates"] = eng.updates
                eng.tel, eng.tel_n = None, 0
            history.append(rec)
            next_eval = (episodes_done // eval_every + 1) * eval_every
            if verbose:
                held = rec["heldout_throughput"]
                print(f"ep {rec['episode']:5d} eps={rec['eps']:.3f} "
                      f"reward={rec['ep_reward']:8.1f} "
                      f"eval_tp={rec['eval_throughput']:.3f} "
                      f"held_tp={held if held is None else f'{held:.3f}'}", flush=True)

    agent.params, agent.target_params, agent.opt = eng.params, eng.target, eng.opt
    agent.env_steps, agent.updates = eng.env_steps, eng.updates
    return agent, history


def _now(device: torch.device) -> float:
    """Host seconds once the device has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


# ---------------------------------------------------------------------------
# Seed-equivalent scalar loop (reference + parity anchor)
# ---------------------------------------------------------------------------

def train_agent_scalar(jobs: list[JobProfile], env_cfg: EnvConfig | None = None,
                       cfg: TrainConfig | None = None,
                       heldout: set[str] | None = None,
                       verbose: bool = False, *, device: str | torch.device = "cuda",
                       warm_start: DQNAgent | None = None) -> tuple[DQNAgent, list[dict]]:
    """The original per-step Python training loop, copied.

    ``warm_start`` (an addition of the port) starts the agent from another
    agent's params, target and Adam state — how a test starts both packages
    from the same initial network, since JAX's and torch's random
    initializations differ."""
    cfg = cfg or TrainConfig()
    env_cfg = env_cfg or EnvConfig()
    env = CoScheduleEnv(env_cfg)
    agent = DQNAgent(env.state_dim, env.n_actions, cfg.dqn, seed=cfg.seed,
                     per_alpha=cfg.per_alpha, per_beta0=cfg.per_beta0,
                     per_eps=cfg.per_eps, device=device)
    if warm_start is not None:
        agent.load_state(warm_start)
    rng = np.random.default_rng(cfg.seed)
    heldout = heldout if heldout is not None else heldout_split(jobs)
    train_queues = _train_queues(jobs, env_cfg, cfg, heldout, rng)

    history: list[dict] = []
    for ep in range(cfg.episodes):
        queue = train_queues[int(rng.integers(0, len(train_queues)))]
        state, mask = env.reset(queue)
        ep_reward = 0.0
        while not env.done:
            action = agent.act(state, mask)
            s2, r, done, mask2, _ = env.step(action)
            agent.observe(state, action, r, s2, done, mask2)
            state, mask = s2, mask2
            ep_reward += r
            for _ in range(cfg.updates_per_step):
                agent.update()
        if (ep + 1) % max(1, cfg.eval_every) == 0 or ep == cfg.episodes - 1:
            sched = RLScheduler(agent, env_cfg).schedule(train_queues[0])
            rec = {"episode": ep + 1, "eps": agent.epsilon, "ep_reward": ep_reward,
                   "eval_throughput": relative_throughput(sched)}
            history.append(rec)
            if verbose:
                print(f"ep {ep+1:5d} eps={agent.epsilon:.3f} "
                      f"reward={ep_reward:8.1f} eval_tp={rec['eval_throughput']:.3f}")
    return agent, history
