"""Offline RL training (paper §IV-B) on a batched engine on the card.

Port of ``repro/core/train.py``: ``train_agent``, ``train_agent_scalar``,
``TrainConfig``, ``heldout_split``, and ``train_online`` (sim-in-the-loop
training on the queueing reward, on the vectorized serving simulator of
``repro_torch/online/vecsim.py``; at the end of this file).

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


# ---------------------------------------------------------------------------
# Sim-in-the-loop training on queueing reward (+ population-based training)
# ---------------------------------------------------------------------------

@dataclass
class TrainOnlineConfig:
    """Config for :func:`train_online` — the environment is the vectorized
    serving simulator itself, so the reward is the real queueing outcome
    (negative per-window wait/turnaround, makespan terminal) rather than
    the offline per-window throughput proxy."""

    rounds: int = 30                    # collect -> update -> eval cycles
    traces_per_round: int = 6           # fresh serving traces per member
    n_arrivals: int = 48                # arrivals per trace
    window: int = 8                     # serve window (<= env_cfg.window)
    backfill: bool = True
    capacity: int = 128                 # engine trace capacity
    scenarios: tuple = (("poisson", 1.25), ("mmpp", 1.25),
                        ("heavy_tailed", 1.1), ("diurnal", 1.0))
    seed: int = 0
    eps_start: float = 0.5              # round-schedule ε (not cfg.dqn's)
    eps_end: float = 0.05
    eps_decay_rounds: int = 20
    updates_per_round: int = 48         # DQN updates after each collect
    target_sync_updates: int = 32       # target refresh cadence, in updates
    push_block: int = 32                # replay ring block-push size
    population: int = 4                 # PBT members
    pbt_interval: int = 5               # rounds between exploit/explore
    pbt_quantile: float = 0.25          # copy bottom q from top q
    eval_traces: int = 6                # shared eval set, one sweep/round
    wait_weight: float = 1.0            # reward mix (per arrival)
    turnaround_weight: float = 0.0
    makespan_weight: float = 1.0
    per_alpha: float = 0.0              # PER exponent; 0 = uniform ring
    per_beta0: float = 0.4
    per_eps: float = 1e-3
    dqn: DQNConfig = field(default_factory=lambda: DQNConfig(buffer_size=20_000))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _stitch_transitions(roll, n_windows: int, makespan: float, cfg: TrainOnlineConfig):
    """Host-side transition stitcher for one trace rollout (numpy, copied).

    Chains every valid decision step (window-major, step order) into one
    serving episode.  Window ``w``'s queueing bucket (member waits +
    turnarounds, normalized per arrival) lands as negative reward on the
    *last* decision of window ``w`` — the close that committed the plan;
    windows with no decisions (all first-sight solos) fold into the most
    recent earlier decision (or the first, for a leading window).  The
    final transition adds the makespan terminal and sets ``done``; its
    ``mask2`` is all-False, which the TD target treats as terminal.
    Returns ``None`` when the trace produced no decisions at all.
    """
    valid = _host(roll.valid)[:n_windows]
    if not valid.any():
        return None
    idx = np.argwhere(valid)                      # row-major: window, step
    m = len(idx)
    obs = _host(roll.obs)[:n_windows]
    act = _host(roll.act)[:n_windows]
    mask = _host(roll.mask)[:n_windows]
    s = obs[idx[:, 0], idx[:, 1]]
    a = act[idx[:, 0], idx[:, 1]]
    mk = mask[idx[:, 0], idx[:, 1]]
    s2 = np.concatenate([s[1:], np.zeros_like(s[:1])])
    mask2 = np.concatenate([mk[1:], np.zeros_like(mk[:1])])
    done = np.zeros(m, np.float32)
    done[-1] = 1.0
    norm = 1.0 / max(1, cfg.n_arrivals)
    bucket = -(cfg.wait_weight * _host(roll.w_wait).astype(np.float64)
               + cfg.turnaround_weight
               * _host(roll.w_turn).astype(np.float64))[:n_windows] * norm
    r = np.zeros(m, np.float64)
    # last decision with window <= w; leading no-decision windows fold
    # forward into the first decision
    tx = np.maximum(np.searchsorted(idx[:, 0], np.arange(n_windows), side="right") - 1, 0)
    np.add.at(r, tx, bucket)
    r[-1] += -cfg.makespan_weight * float(makespan) * norm
    return {"s": s.astype(np.float32), "a": a.astype(np.int32), "r": r.astype(np.float32),
            "s2": s2.astype(np.float32), "done": done, "mask2": mask2.astype(bool)}


def _online_updater(dqn_cfg: DQNConfig, n_updates: int, sync_updates: int, per):
    """The K-update loop over a replay ring: sample -> double-DQN step ->
    priority refresh (PER) -> cadenced target sync.  ``per`` is None for
    the uniform ring or ``(alpha, per_eps)`` for the sum-tree.

    Returns ``run(params, target, opt, replay, generator, updates, beta,
    draws=None)`` -> ``(params, target, opt, replay, updates)``, a Python
    loop (the reference's ``lax.fori_loop``).  Update ``i`` samples with
    ``draws[i]`` when given (the uniform ring's indices, or the PER
    stratified uniforms), else from ``generator`` (on the ring's device)."""

    def run(params, target, opt, replay, generator, updates: int, beta: float, draws=None):
        bs = dqn_cfg.batch_size
        for i in range(n_updates):
            d = None if draws is None else draws[i]
            if per is None:
                batch = replay_sample(replay, bs, idx=d, generator=generator)
                params, opt, _ = _dqn_update(params, target, opt, batch, dqn_cfg)
            else:
                alpha, p_eps = per
                batch, idx, w = per_sample(replay, bs, alpha, beta, u=d, generator=generator)
                params, opt, _, td = _dqn_update_per(params, target, opt, batch, w, dqn_cfg)
                if alpha > 0.0:
                    replay = per_update(replay, idx, td, alpha, p_eps)
            updates += 1
            if updates % sync_updates == 0:
                target = {k: v.clone() for k, v in params.items()}
        return params, target, opt, replay, updates

    return run


_COLLECTOR_CACHE: dict = {}


def _collector_for(env_cfg: EnvConfig, cfg: TrainOnlineConfig, device: torch.device):
    from repro_torch.online.vecsim import make_rollout_collector
    key_t = (env_cfg.key(), cfg.window, cfg.backfill, cfg.capacity, str(device))
    if key_t not in _COLLECTOR_CACHE:
        if len(_COLLECTOR_CACHE) >= 8:
            _COLLECTOR_CACHE.pop(next(iter(_COLLECTOR_CACHE)))
        _COLLECTOR_CACHE[key_t] = make_rollout_collector(
            env_cfg, window=cfg.window, backfill=cfg.backfill, capacity=cfg.capacity,
            device=device)
    return _COLLECTOR_CACHE[key_t]


def _seed_of(*parts: int) -> int:
    """A generator seed for one (seed, round, member, stream) tuple."""
    return int(np.random.SeedSequence(list(parts)).generate_state(1, np.uint64)[0] >> 1)


def _clone_state(params: dict, target: dict, opt: dict):
    def cp(tree):
        return {k: v.clone() for k, v in tree.items()}
    return cp(params), cp(target), {"m": cp(opt["m"]), "v": cp(opt["v"]), "t": opt["t"].clone()}


def train_online(jobs: list[JobProfile], env_cfg: EnvConfig | None = None,
                 cfg: TrainOnlineConfig | None = None, warm_start: DQNAgent | None = None,
                 verbose: bool = False, *, device: str | torch.device = "cuda"
                 ) -> tuple[DQNAgent, list[dict]]:
    """Sim-in-the-loop training on ``device``: the vectorized serving
    simulator is the environment, queueing outcome is the reward.

    Each round, every population member rolls ``traces_per_round`` fresh
    traces of its (family, load) scenario through the ε-greedy rollout
    collector, the host stitches the logged window-seam decisions into
    replay transitions whose rewards are the engine-accumulated per-window
    wait/turnaround (plus a terminal makespan term), and
    ``updates_per_round`` double-DQN updates run on the member's ring.  All
    members are then scored in ONE ``sweep(param_sets=...)`` call on a
    shared eval-trace set (mean p99 wait — lower is better); every
    ``pbt_interval`` rounds the bottom ``pbt_quantile`` of members copy the
    top performers' weights and re-draw their exploration scale and
    scenario.  Returns the best member as a :class:`DQNAgent` plus
    per-round history.  With ``warm_start`` (an agent on ``device``) the
    population starts from its weights, and its unchanged params are scored
    in the final eval as an elitism guard: if no trained member beats them
    strictly, they are returned (``history[-1]["selected"] ==
    "warm_start"``).

    The random streams are seeded from ``(cfg.seed, round, member)``: the
    episode draws on the host, the replay samples on the device, so one
    seed gives the same history on one device.
    """
    from repro_torch.core.partition import N_UNITS
    from repro_torch.online import TRACE_FAMILIES
    from repro_torch.online.policies import RLDispatchPolicy
    from repro_torch.online.vecsim import (
        VectorizedClusterSimulator, build_rl_job_table, compile_trace, same_device, stack_traces,
    )

    cfg = cfg or TrainOnlineConfig()
    env_cfg = env_cfg or EnvConfig()
    device = torch.device(device)
    if cfg.window > env_cfg.window:
        raise ValueError(f"serve window {cfg.window} > agent window {env_cfg.window}")
    for fam, _ld in cfg.scenarios:
        if fam not in TRACE_FAMILIES:
            raise ValueError(f"unknown trace family {fam!r}")
    if warm_start is not None and not same_device(warm_start.device, device):
        raise ValueError(f"warm_start agent lives on {warm_start.device}, training on {device}")
    env = CoScheduleEnv(env_cfg)
    state_dim, n_actions = env.state_dim, env.n_actions
    pop = max(1, cfg.population)
    rng = np.random.default_rng(cfg.seed)
    collect = _collector_for(env_cfg, cfg, device)
    use_per = cfg.per_alpha > 0.0
    per_t = (cfg.per_alpha, cfg.per_eps) if use_per else None
    updater = _online_updater(cfg.dqn, cfg.updates_per_round, max(1, cfg.target_sync_updates),
                              per_t)
    blk = cfg.push_block
    ring_cap = -(-cfg.dqn.buffer_size // blk) * blk

    def _fresh_member(m: int) -> dict:
        if warm_start is not None:
            params, target, opt = _clone_state(warm_start.params, warm_start.target_params,
                                               warm_start.opt)
        else:
            seed_agent = DQNAgent(state_dim, n_actions, cfg.dqn, seed=cfg.seed + m, device=device)
            params, target, opt = seed_agent.params, seed_agent.target_params, seed_agent.opt
        ring = (per_init(ring_cap, state_dim, n_actions, device) if use_per
                else replay_init(ring_cap, state_dim, n_actions, device))
        return {"params": params, "target": target, "opt": opt, "replay": ring,
                "updates": 0, "stage": {f: [] for f in ("s", "a", "r", "s2", "done", "mask2")},
                "staged": 0, "env_steps": 0, "eps_scale": 1.0,
                "scenario": m % len(cfg.scenarios), "score": float("inf")}

    members = [_fresh_member(m) for m in range(pop)]

    # shared eval traces, round-robin over the scenario axis
    eval_traces = [
        TRACE_FAMILIES[cfg.scenarios[t % len(cfg.scenarios)][0]](
            jobs, n=cfg.n_arrivals, load=cfg.scenarios[t % len(cfg.scenarios)][1],
            seed=cfg.seed + 9000 + t)
        for t in range(max(1, cfg.eval_traces))]
    eval_agent = DQNAgent(state_dim, n_actions, cfg.dqn, seed=cfg.seed, device=device)
    vec = VectorizedClusterSimulator(RLDispatchPolicy(eval_agent, env_cfg), window=cfg.window,
                                     backfill=cfg.backfill, capacity=cfg.capacity, device=device)

    def _eval_scores(param_list) -> np.ndarray:
        summ = vec.sweep(eval_traces, param_sets=param_list)
        return summ.p99_wait.cpu().numpy().astype(np.float64).mean(axis=1)

    widths = torch.full((cfg.traces_per_round,), N_UNITS, dtype=torch.int64, device=device)
    history: list[dict] = []
    total_tx = 0
    for rnd in range(cfg.rounds):
        frac = min(1.0, rnd / max(1, cfg.eps_decay_rounds))
        eps_round = cfg.eps_start + (cfg.eps_end - cfg.eps_start) * frac
        for m, mem in enumerate(members):
            fam, load = cfg.scenarios[mem["scenario"]]
            traces = [TRACE_FAMILIES[fam](jobs, n=cfg.n_arrivals, load=load,
                                          seed=cfg.seed + 1 + rnd * 131 + m * 17 + t)
                      for t in range(cfg.traces_per_round)]
            names: dict[str, int] = {}
            tjobs: list = []
            batch = stack_traces([compile_trace(t, cfg.capacity, names, tjobs, device="cpu")[0]
                                  for t in traces], device)
            rjt = build_rl_job_table(tjobs, device)
            eps = min(1.0, eps_round * mem["eps_scale"])
            gen = torch.Generator().manual_seed(_seed_of(cfg.seed, rnd, m, 0))
            summ, roll = collect(batch, rjt, mem["params"], eps, widths, generator=gen)
            VectorizedClusterSimulator._check_err(int(summ.err.max()))
            n_win = summ.dispatches.cpu().numpy()
            mks = summ.makespan.cpu().numpy().astype(np.float64)
            roll_np = type(roll)(*(_host(x) for x in roll))
            for t in range(cfg.traces_per_round):
                one = type(roll)(*(x[t] for x in roll_np))
                tx = _stitch_transitions(one, int(n_win[t]), float(mks[t]), cfg)
                if tx is None:
                    continue
                for f in mem["stage"]:
                    mem["stage"][f].append(tx[f])
                mem["staged"] += len(tx["a"])
                mem["env_steps"] += len(tx["a"])
                total_tx += len(tx["a"])
            # block-aligned ring pushes; the remainder stays staged
            if mem["staged"] >= blk:
                full = {f: np.concatenate(v) for f, v in mem["stage"].items()}
                n_push = (mem["staged"] // blk) * blk
                for lo in range(0, n_push, blk):
                    chunk = {f: torch.as_tensor(v[lo:lo + blk], device=device)
                             for f, v in full.items()}
                    chunk["a"] = chunk["a"].long()
                    mem["replay"] = (per_push(mem["replay"], chunk) if use_per
                                     else replay_push(mem["replay"], chunk))
                for f in mem["stage"]:
                    mem["stage"][f] = [full[f][n_push:]]
                mem["staged"] -= n_push
            if mem["replay"].size >= cfg.dqn.batch_size:
                beta = beta_at(cfg.per_beta0, mem["env_steps"], cfg.dqn.eps_decay_steps)
                ugen = torch.Generator(device).manual_seed(_seed_of(cfg.seed, rnd, m, 1))
                (mem["params"], mem["target"], mem["opt"], mem["replay"],
                 mem["updates"]) = updater(mem["params"], mem["target"], mem["opt"],
                                           mem["replay"], ugen, mem["updates"], beta)

        scores = _eval_scores([mem["params"] for mem in members])
        for mem, sc in zip(members, scores):
            mem["score"] = float(sc)
        order = np.argsort(scores, kind="stable")
        rec = {"round": rnd + 1, "eps": float(eps_round), "scores": [float(s) for s in scores],
               "best_member": int(order[0]), "best_p99": float(scores[order[0]]),
               "transitions": total_tx}
        if pop > 1 and cfg.pbt_interval > 0 and rnd < cfg.rounds - 1 \
                and (rnd + 1) % cfg.pbt_interval == 0:
            n_q = max(1, int(pop * cfg.pbt_quantile))
            swaps = []
            for dst, src in zip(order[-n_q:], order[:n_q]):
                lo, hi = members[dst], members[src]
                lo["params"], lo["target"], lo["opt"] = _clone_state(hi["params"], hi["target"],
                                                                     hi["opt"])
                lo["eps_scale"] = float(np.clip(hi["eps_scale"] * rng.choice([0.8, 1.25]),
                                                0.25, 2.0))
                lo["scenario"] = int(rng.integers(len(cfg.scenarios)))
                swaps.append((int(dst), int(src)))
            rec["pbt"] = swaps
        history.append(rec)
        if verbose:
            print(f"round {rnd + 1:3d} eps={eps_round:.3f} best_p99={rec['best_p99']:.2f} "
                  f"tx={total_tx}", flush=True)

    # final selection (+ warm-start elitism guard: a refresh must beat the
    # incumbent strictly on eval, else the incumbent's weights are kept)
    finals = [mem["params"] for mem in members]
    labels: list = list(range(pop))
    if warm_start is not None:
        finals.append(warm_start.params)
        labels.append("warm_start")
    scores = _eval_scores(finals)
    best = int(np.argmin(scores[:pop]))
    if warm_start is not None and scores[pop] <= scores[best]:
        best = pop
    selected = labels[best]
    agent = DQNAgent(state_dim, n_actions, cfg.dqn, seed=cfg.seed, per_alpha=cfg.per_alpha,
                     per_beta0=cfg.per_beta0, per_eps=cfg.per_eps, device=device)
    if selected == "warm_start":
        agent.params, agent.target_params, agent.opt = _clone_state(
            warm_start.params, warm_start.target_params, warm_start.opt)
    else:
        mem = members[selected]
        agent.params, agent.target_params, agent.opt = mem["params"], mem["target"], mem["opt"]
        agent.env_steps = int(mem["env_steps"])
        agent.updates = int(mem["updates"])
    if history:
        history[-1]["selected"] = "warm_start" if selected == "warm_start" else int(selected)
        history[-1]["final_scores"] = [float(s) for s in scores]
    return agent, history
