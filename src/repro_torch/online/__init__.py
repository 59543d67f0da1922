"""Online cluster serving: event-driven multi-tenant arrivals + re-training.

Port of ``repro/online``'s heap path: the discrete-event
:class:`~repro_torch.online.simulator.ClusterSimulator` with its trace
families, routers, dispatch policies, telemetry and the periodic
:class:`~repro_torch.online.retrain.OnlineRetrainer`.  Everything but the
RL policy is pure Python and numpy, copied from the reference; the RL
policy runs the port's ``RLScheduler`` and ``DQNAgent`` (the agent's
forward on its device), and the retrainer the port's ``train_agent``.
The vectorized simulator (``repro/online/vecsim.py``) and the queueing
reward's ``train_online`` are not ported yet.

See the reference package's docstring for the event model, fleet serving,
the traces' mapping to the paper's queue mixes, the arrival-aware
observations and the telemetry layer; all of it holds here unchanged.
"""
from repro_torch.online.policies import (
    DispatchPolicy, GreedyPackerPolicy, PolicyStats, RLDispatchPolicy,
    StaticPartitionPolicy, TimeSharingPolicy,
)
from repro_torch.online.retrain import OnlineRetrainer, default_retrain_train_config
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

__all__ = [
    "Arrival", "ClusterSimulator", "DispatchPolicy", "DriftMonitor",
    "FleetView", "FragRouter", "GreedyPackerPolicy", "HashRouter",
    "JobRecord", "LeastLoadedRouter", "MetricsRegistry", "OnlineRetrainer",
    "PhaseTimer", "PodView", "PolicyStats", "ROUTERS", "RLDispatchPolicy",
    "Router", "Segment", "SimConfig", "SimResult", "StaticPartitionPolicy",
    "TRACE_FAMILIES", "Telemetry", "TimeSharingPolicy", "TraceRecorder",
    "WAIT_BUCKETS_S", "default_retrain_train_config", "diurnal_trace",
    "fragmented_trace", "heavy_tailed_trace", "make_router", "mmpp_trace",
    "poisson_trace",
]
