"""Online cluster serving: event-driven multi-tenant arrivals + re-training.

Port of ``repro/online``: the discrete-event
:class:`~repro_torch.online.simulator.ClusterSimulator` with its trace
families, routers, dispatch policies, telemetry and the periodic
:class:`~repro_torch.online.retrain.OnlineRetrainer`, and the vectorized
simulator (:mod:`~repro_torch.online.vecsim`): batched traces, pods or
agents as the lanes of one engine call on the card, and the rollout
collector of sim-in-the-loop training.  The heap path is pure Python and
numpy, copied from the reference; the RL policy runs the port's
``RLScheduler`` and ``DQNAgent`` (the agent's forward on its device), and
the retrainer the port's ``train_agent`` (proxy reward) or
``train_online`` (queueing reward).

See the reference package's docstring for the event model, fleet serving,
the traces' mapping to the paper's queue mixes, the arrival-aware
observations and the telemetry layer; all of it holds here unchanged.
"""
from repro_torch.online.policies import (
    DispatchPolicy, GreedyPackerPolicy, PolicyStats, RLDispatchPolicy,
    StaticPartitionPolicy, TimeSharingPolicy,
)
from repro_torch.online.retrain import (
    OnlineRetrainer, default_retrain_online_config, default_retrain_train_config,
)
from repro_torch.online.router import (
    FleetView, FragRouter, HashRouter, LeastLoadedRouter, PodView, ROUTERS,
    Router, make_router,
)
from repro_torch.online.simulator import (
    Arrival, ClusterSimulator, JobRecord, Segment, SimConfig, SimResult,
)
from repro_torch.online.telemetry import (
    DriftMonitor, MetricsRegistry, PhaseTimer, Telemetry, TraceRecorder,
    WAIT_BUCKETS_S,
)
from repro_torch.online.traces import (
    TRACE_FAMILIES, diurnal_trace, fragmented_trace, heavy_tailed_trace,
    mmpp_trace, poisson_trace,
)
from repro_torch.online.vecsim import (
    SweepSummary, TrainRollout, VectorizedClusterSimulator,
    VectorizedFleetSimulator, make_rollout_collector,
)

__all__ = [
    "Arrival", "ClusterSimulator", "DispatchPolicy", "DriftMonitor",
    "FleetView", "FragRouter", "GreedyPackerPolicy", "HashRouter",
    "JobRecord", "LeastLoadedRouter", "MetricsRegistry", "OnlineRetrainer",
    "PhaseTimer", "PodView", "PolicyStats", "ROUTERS", "RLDispatchPolicy",
    "Router", "Segment", "SimConfig", "SimResult", "StaticPartitionPolicy",
    "SweepSummary", "TRACE_FAMILIES", "Telemetry", "TimeSharingPolicy",
    "TraceRecorder", "TrainRollout", "VectorizedClusterSimulator",
    "VectorizedFleetSimulator", "WAIT_BUCKETS_S",
    "default_retrain_online_config", "default_retrain_train_config",
    "diurnal_trace", "fragmented_trace", "heavy_tailed_trace",
    "make_rollout_collector", "make_router", "mmpp_trace", "poisson_trace",
]
