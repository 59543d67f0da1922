"""MISO-style periodic re-training against the live profile repository.
Port of ``repro/online/retrain.py``: the proxy reward on the port's
``train_agent``, the queueing reward on its ``train_online``, both on the
serving agent's device.

Every ``interval_s`` of *simulated* time (driven by the simulator's TICK
events), the retrainer snapshots the profile repository — exactly the
applications the cluster has observed and profiled so far — re-trains the
DQN co-scheduler on queues drawn from that snapshot, **warm-starting** from
the serving agent's current params, target and optimizer state, and hot-swaps
the refreshed agent into the dispatch policy.  The batched training engine
(``train_agent``) makes minute-scale refresh cycles affordable: one cycle
at the default retrain budget is a few hundred episodes.

Re-training waits until the repository holds at least ``min_jobs`` distinct
profiles (early ticks on a cold repository would train on one or two
applications and overfit the Q-function to them).  Queues are built with
``strict=False``, so a repository that does not yet span all three CI/MI/US
classes still trains — recipes remap onto the classes observed.

Arrival-aware serving agents re-train transparently: the retrainer derives
its environment config from the serving policy (below), so an agent whose
``EnvConfig.obs_context`` is set refreshes on the context-widened
observation — ``train_agent`` samples per-episode cluster-state contexts
inside the batched rollout (``docs/observation.md``), and the hot-swapped
agent keeps consuming the simulator's real dispatch snapshots.  Nothing in
this module branches on the observation mode.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.core.agent import DQNConfig
from repro_torch.core.train import TrainConfig, TrainOnlineConfig, train_agent, train_online
from repro_torch.online.policies import RLDispatchPolicy
from repro_torch.online.telemetry import DriftMonitor


def default_retrain_train_config(episodes: int = 240) -> TrainConfig:
    """A refresh-sized training budget: modest exploration restart (the
    warm-started Q-function needs adaptation, not rediscovery), small queue
    set, one history record per cycle."""
    return TrainConfig(
        episodes=episodes, eval_every=episodes, n_train_queues=8,
        n_heldout_queues=0, strict_classes=False, batch_envs=8,
        update_every=8,
        dqn=DQNConfig(eps_start=0.25, eps_end=0.01, eps_decay_steps=2000,
                      buffer_size=20_000),
    )


def default_retrain_online_config(rounds: int = 8) -> TrainOnlineConfig:
    """A refresh-sized sim-in-the-loop budget (``reward="queueing"``):
    a handful of collect/update rounds, no population (the warm-started
    incumbent IS the population seed and the elitism guard keeps it when
    the refresh does not improve eval p99 wait)."""
    return TrainOnlineConfig(
        rounds=rounds, traces_per_round=4, n_arrivals=32, capacity=96,
        population=1, eval_traces=4, updates_per_round=32,
        eps_start=0.25, eps_end=0.05, eps_decay_rounds=max(1, rounds - 2),
        dqn=DQNConfig(buffer_size=20_000),
    )


@dataclass
class OnlineRetrainer:
    """Tick callback for :class:`~repro_torch.online.simulator.ClusterSimulator`.

    Attach with ``ClusterSimulator(policy, tick_interval_s=cfg.interval_s,
    on_tick=retrainer)``; ``history`` records one entry per completed
    re-training cycle (simulated time, repository size, final train eval).
    The environment config is the serving policy's own (the agent must be
    re-trained for exactly the env it schedules in), so it is derived, not
    passed.

    ``trigger`` selects when a tick actually retrains:

    * ``"clock"`` (default) — every tick, the original MISO-style periodic
      refresh.  Bit-compatible with pre-trigger behaviour.
    * ``"drift"`` — each tick feeds the interval's arrival class/width mix
      and the live idle-slice fraction to a
      :class:`~repro_torch.online.telemetry.DriftMonitor`; re-training runs only
      on a drift verdict, and the monitor's baselines are rebased
      afterwards (the refreshed agent defines the new normal).  History
      entries gain ``trigger``/``signals``/``reasons`` fields; skipped
      ticks leave no entry (``monitor.history`` has the full verdict log).

    ``reward`` selects what the refresh optimizes:

    * ``"proxy"`` (default) — ``train_agent`` on the offline per-window
      throughput proxy, bit-compatible with pre-queueing behaviour.
    * ``"queueing"`` — ``train_online`` rolls the repository's jobs as
      serving traces through the vectorized simulator and optimizes the
      engine-accumulated wait/turnaround + makespan reward directly (the
      metric the drift monitor watches), warm-started from the incumbent;
      ``online_cfg`` sizes the refresh
      (:func:`default_retrain_online_config` when unset).  History entries
      carry ``rounds``/``train_eval_p99_wait``/``selected`` instead of the
      proxy's ``episodes``/``train_eval_throughput``.

    The refresh trains on the serving agent's device.
    """

    policy: RLDispatchPolicy
    train_cfg: TrainConfig = field(default_factory=default_retrain_train_config)
    interval_s: float = 1800.0           # K simulated minutes between cycles
    min_jobs: int = 4
    reseed: bool = True                  # vary queue draws across cycles
    trigger: str = "clock"               # "clock" | "drift"
    reward: str = "proxy"                # "proxy" | "queueing"
    online_cfg: TrainOnlineConfig | None = None
    monitor: DriftMonitor = field(default_factory=DriftMonitor)
    history: list = field(default_factory=list)

    def __post_init__(self):
        if self.trigger not in ("clock", "drift"):
            raise ValueError(f"unknown trigger {self.trigger!r}; "
                             f"expected 'clock' or 'drift'")
        if self.reward not in ("proxy", "queueing"):
            raise ValueError(f"unknown reward {self.reward!r}; "
                             f"expected 'proxy' or 'queueing'")
        self._last_t = 0.0

    def __call__(self, now: float, sim) -> None:
        extra: dict = {}
        if self.trigger == "drift":
            arrivals = sim.live_arrivals(self._last_t, now)
            self._last_t = now
            cc: dict[str, int] = {}
            wc: dict[int, int] = {}
            for a in arrivals:
                cc[a.profile.job_class] = cc.get(a.profile.job_class, 0) + 1
                w = a.profile.requested_units
                wc[w] = wc.get(w, 0) + 1
            verdict = self.monitor.observe(cc, wc, sim.live_idle_frac())
            if not verdict["drift"]:
                return
            extra = {"trigger": "drift", "signals": verdict["signals"],
                     "reasons": verdict["reasons"]}
        repo = self.policy.repository
        jobs = repo.jobs()
        if len(jobs) < self.min_jobs:
            return
        env_cfg = self.policy.scheduler.env_cfg
        if self.reward == "queueing":
            cfg = self.online_cfg or default_retrain_online_config()
            if cfg.window > env_cfg.window:
                # one formation must not span several RL episodes
                cfg = replace(cfg, window=env_cfg.window)
            if self.reseed:
                cfg = replace(cfg, seed=cfg.seed + len(self.history))
            agent, hist = train_online(jobs, env_cfg, cfg, warm_start=self.policy.agent,
                                       device=self.policy.agent.device)
            cycle = {"rounds": hist[-1]["round"],
                     "train_eval_p99_wait": min(hist[-1]["final_scores"]),
                     "selected": hist[-1]["selected"]}
        else:
            cfg = self.train_cfg
            if self.reseed:
                cfg = replace(cfg, seed=cfg.seed + len(self.history))
            agent, hist = train_agent(jobs, env_cfg, cfg, heldout=set(),
                                      warm_start=self.policy.agent,
                                      device=self.policy.agent.device)
            cycle = {"episodes": hist[-1]["episode"],
                     "train_eval_throughput": hist[-1]["eval_throughput"]}
        self.policy.hot_swap(agent)
        self.history.append({
            "t_s": now,
            "repository_jobs": len(jobs),
            "class_counts": repo.class_counts(),
            **cycle,
            **extra,
        })
        if self.trigger == "drift":
            self.monitor.rebase()
