"""The paper's RL co-scheduler: profiles, partition space, co-run model,
environments, the DQN agent, its training, the baselines and the online
scheduler, and sim-in-the-loop training on the queueing reward
(``train_online``)."""
from repro_torch.core.agent import DQNAgent, DQNConfig, act_batch, beta_at, epsilon_at
from repro_torch.core.baselines import POLICIES, oracle, time_sharing
from repro_torch.core.env import (
    CoScheduleEnv, DispatchContext, EnvConfig, EnvState, ObsContext, VecCoScheduleEnv,
    dispatch_obs_context, zero_context,
)
from repro_torch.core.metrics import summarize
from repro_torch.core.network import widen_dqn_params
from repro_torch.core.partition import Partition, Slice, enumerate_partitions
from repro_torch.core.perfmodel import corun, corun_time, solo_run_time
from repro_torch.core.problem import Schedule, validate_schedule
from repro_torch.core.profiles import JobProfile, ProfileRepository, analytic_profile
from repro_torch.core.replay import (
    PrioritizedReplayBuffer, PrioritizedReplayState, ReplayBuffer, ReplayState, per_init,
    per_push, per_sample, per_update, replay_init, replay_push, replay_sample,
)
from repro_torch.core.scheduler import RLScheduler
from repro_torch.core.train import (
    TrainConfig, TrainOnlineConfig, heldout_split, train_agent, train_agent_scalar, train_online,
)
from repro_torch.core.workloads import make_queue, make_zoo, paper_queues

__all__ = [
    "CoScheduleEnv", "DQNAgent", "DQNConfig", "DispatchContext", "EnvConfig",
    "EnvState", "JobProfile", "ObsContext", "POLICIES", "Partition",
    "PrioritizedReplayBuffer", "PrioritizedReplayState", "ProfileRepository",
    "RLScheduler", "ReplayBuffer", "ReplayState", "Schedule", "Slice",
    "TrainConfig", "TrainOnlineConfig", "VecCoScheduleEnv", "act_batch", "analytic_profile",
    "beta_at", "corun", "corun_time", "dispatch_obs_context",
    "enumerate_partitions", "epsilon_at", "heldout_split", "make_queue",
    "make_zoo", "oracle", "paper_queues", "per_init", "per_push",
    "per_sample", "per_update", "replay_init", "replay_push",
    "replay_sample", "solo_run_time", "summarize", "time_sharing",
    "train_agent", "train_agent_scalar", "train_online", "validate_schedule",
    "widen_dqn_params", "zero_context",
]
