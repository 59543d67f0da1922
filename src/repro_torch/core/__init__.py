"""The paper's RL co-scheduler: profiles, partition space, co-run model,
scalar environment, greedy DQN agent and the online scheduler (serving
side only; training is not ported yet)."""
from repro_torch.core.agent import DQNAgent
from repro_torch.core.env import (
    CoScheduleEnv, DispatchContext, EnvConfig, ObsContext, dispatch_obs_context,
    zero_context,
)
from repro_torch.core.network import widen_dqn_params
from repro_torch.core.partition import Partition, Slice, enumerate_partitions
from repro_torch.core.perfmodel import corun, corun_time, solo_run_time
from repro_torch.core.problem import Schedule, validate_schedule
from repro_torch.core.profiles import JobProfile, ProfileRepository, analytic_profile
from repro_torch.core.scheduler import RLScheduler
from repro_torch.core.workloads import make_queue, make_zoo, paper_queues

__all__ = [
    "CoScheduleEnv", "DQNAgent", "DispatchContext", "EnvConfig",
    "JobProfile", "ObsContext", "Partition", "ProfileRepository",
    "RLScheduler", "Schedule", "Slice", "analytic_profile", "corun",
    "corun_time", "dispatch_obs_context", "enumerate_partitions",
    "make_queue", "make_zoo", "paper_queues", "solo_run_time",
    "validate_schedule", "widen_dqn_params", "zero_context",
]
