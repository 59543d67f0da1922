"""The port's vectorized simulator, time sharing and the fleet.

Most cases hold ``repro_torch.online.vecsim`` against the port's own heap
simulator, which ``tests/test_torch_online.py`` holds key for key to the
reference's heap: decisions exactly (placement order, groups, partitions,
slice ranges, backfill flags and counts, refits), times to f32 resolution
of the clock (the engine's lanes are f32, the heap's clock f64; the bound
is ``tests/strategies.py``'s ``close``).  One trace runs through the JAX
engine too (one compile): the records and the summary equal, times within
rtol 1e-6.  Everything runs on the CPU at small sizes."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import online as jo
from repro.core import make_zoo as jzoo
from repro_torch import online as to
from repro_torch.core import make_zoo
from repro_torch.convert import GOLDEN_WINDOW, load_golden_dqn
from repro_torch.core.env import EnvConfig
from repro_torch.online import vecsim as tv

ZOO = make_zoo(dryrun_dir=None)
GOLDEN = "tests/golden/train_agent_proxy_v1.npz"
_ENGINES: dict = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The engine is thousands of small ops: one intra-op thread does them as
    fast as eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(a, b):
    # f32 lanes against the f64 heap: an absolute floor for waits near 0,
    # relative for late timestamps
    return abs(a - b) <= max(0.05, 1e-4 * max(abs(a), abs(b)))


def assert_parity(h, v):
    """Decision-level equality and f32-resolution times between engines."""
    assert len(v.jobs) == len(h.jobs)
    key = lambda r: (r.arrival, r.name)  # noqa: E731
    for a, b in zip(sorted(h.jobs, key=key), sorted(v.jobs, key=key)):
        assert (a.name, a.binary, a.units, a.partition, a.group_size, a.backfilled, a.pod) == \
            (b.name, b.binary, b.units, b.partition, b.group_size, b.backfilled, b.pod), a.name
        assert close(a.dispatch, b.dispatch), (a.name, a.dispatch, b.dispatch)
        assert close(a.finish, b.finish), (a.name, a.finish, b.finish)
    assert (v.dispatches, v.backfills, v.refits) == (h.dispatches, h.backfills, h.refits)
    assert len(v.timeline) == len(h.timeline)
    for s, t in zip(h.timeline, v.timeline):
        assert (t.slices, t.partition, t.backfilled, t.pod, t.jobs) == \
            (s.slices, s.partition, s.backfilled, s.pod, s.jobs)
        assert close(s.t0, t.t0) and close(s.t1, t.t1)
    assert close(h.busy_time, v.busy_time)
    assert all(close(x, y) for x, y in zip(h.slice_busy_s, v.slice_busy_s))


def _ts(window=8, backfill=True, capacity=96, telemetry=False):
    key = (window, backfill, capacity, telemetry)
    if key not in _ENGINES:
        _ENGINES[key] = tv.VectorizedClusterSimulator(
            to.TimeSharingPolicy(), window=window, backfill=backfill, capacity=capacity,
            telemetry=telemetry, device="cpu")
    return _ENGINES[key]


def _heap(trace, window=8, backfill=True, policy=None, **kw):
    return to.ClusterSimulator(policy or to.TimeSharingPolicy(), window=window,
                               backfill=backfill, **kw).run(trace)


def _trace(fam, n, seed, load, capacity=1.0):
    return to.TRACE_FAMILIES[fam](ZOO, n=n, load=load, seed=seed, capacity=capacity)


# randomized (family, n, seed, load) specs, drawn once from a numpy seed
_RNG = np.random.default_rng(2024)
SPECS = [(str(_RNG.choice(sorted(to.TRACE_FAMILIES))), int(_RNG.integers(5, 61)),
          int(_RNG.integers(0, 51)), float(_RNG.uniform(0.5, 1.8))) for _ in range(10)]


@pytest.mark.parametrize("spec", SPECS, ids=[f"{f}-{n}-{s}" for f, n, s, _ in SPECS])
def test_ts_matches_heap_on_random_traces(spec):
    trace = _trace(*spec)
    assert_parity(_heap(trace), _ts().run(trace))


def test_ts_backfill_heavy():
    """Overloaded fragmented traces exercise the EASY-backfill scan."""
    total = 0
    for seed in range(4):
        trace = _trace("fragmented", 40, seed, 1.6)
        h = _heap(trace)
        assert_parity(h, _ts().run(trace))
        total += h.backfills
    assert total > 0


@pytest.mark.parametrize("window", [1, 2, 4])
def test_ts_small_windows(window):
    trace = _trace("mmpp", 30, 7, 1.3)
    assert_parity(_heap(trace, window=window), _ts(window=window).run(trace))


def test_ts_backfill_disabled():
    trace = _trace("fragmented", 40, 1, 1.6)
    assert_parity(_heap(trace, backfill=False), _ts(backfill=False).run(trace))


def test_ts_coincident_arrivals_share_one_window():
    trace = [to.Arrival(t=10.0, binary=f"bin://co{i}", profile=ZOO[i]) for i in range(4)]
    trace += [to.Arrival(t=10.0, binary=f"bin://co{i}", profile=ZOO[i]) for i in range(2)]
    v = _ts(window=4).run(trace)
    assert_parity(_heap(trace, window=4), v)
    assert v.dispatches == 2


def test_ts_telemetry_keeps_the_trajectory_and_matches_the_heap():
    """With telemetry on the ``_State`` lanes are the same as with it off,
    and the in-loop metrics agree with the heap's registry."""
    traces = [_trace("fragmented", 40, s, 1.6) for s in range(2)]
    names, jobs = {}, []
    batch = tv.stack_traces([tv.compile_trace(t, 96, names, jobs, device="cpu")[0]
                             for t in traces])
    jt = tv.build_job_table(jobs, "cpu")
    widths = torch.full((2,), 8)
    off = tv._build_run(8, True, 96)(batch, jt, widths)
    on, ms = tv._build_run(8, True, 96, telemetry=True)(batch, jt, widths)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    tel = to.Telemetry()
    h = to.ClusterSimulator(to.TimeSharingPolicy(), window=8, telemetry=tel).run(traces[0])
    eng = _ts(telemetry=True)
    v = eng.run(traces[0])
    assert_parity(h, v)
    m = eng.last_metrics
    reg = {d["name"]: d for d in tel.metrics.to_dicts()}
    assert m["wait_s"]["counts"] == reg["wait_s"]["counts"]
    assert m["wait_s"]["count"] == len(h.jobs)
    assert m["groups_placed"] == reg["groups_placed"]["value"]
    # the reference's bounds for f32 sums against the heap's f64 ones
    assert m["wait_s"]["sum"] == pytest.approx(reg["wait_s"]["sum"], rel=1e-3, abs=0.5)
    for k in ("busy_unit_s", "queue_depth_integral_s"):
        assert m[k] == pytest.approx(reg[k]["value"], rel=1e-3, abs=1.0)
    assert m == tv.metrics_dict(tv.MetricsState(*(x[0] for x in ms)))


def test_ts_matches_the_jax_engine():
    """One trace through both engines (the reference's engine compiles once):
    records, timeline and summary equal, times within rtol 1e-6, and the
    same telemetry."""
    kw = dict(window=4, capacity=64, telemetry=True)
    trj = jo.TRACE_FAMILIES["fragmented"](jzoo(dryrun_dir=None), n=40, load=1.5, seed=1)
    trt = _trace("fragmented", 40, 1, 1.5)
    ej = jo.VectorizedClusterSimulator(jo.TimeSharingPolicy(), **kw)
    et = tv.VectorizedClusterSimulator(to.TimeSharingPolicy(), device="cpu", **kw)
    rj, rt = ej.run(trj), et.run(trt)
    assert rj.backfills > 0
    for a, b in zip(rj.jobs, rt.jobs):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in ("dispatch", "finish"):
            assert b.pop(k) == pytest.approx(a.pop(k), rel=1e-6)
        assert a == b
    assert [dataclasses.asdict(s) for s in rj.timeline] == \
        pytest.approx([dataclasses.asdict(s) for s in rt.timeline], rel=1e-6)
    assert rj.summary() == pytest.approx(rt.summary(), rel=1e-6)
    assert ej.last_metrics == et.last_metrics
    sj = ej.sweep([trj, trj[:20]])
    st = et.sweep([trt, trt[:20]])
    for name, a, b in zip(st._fields, sj, st):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, err_msg=name)


def test_sweep_rows_match_single_trace_runs():
    """Each lane of a sweep equals the single-trace run: batching must not
    change a lane's result, and a lane that finished early is frozen while
    the others run on (its clock, counters and metrics stay as they were)."""
    eng = _ts(capacity=64)
    traces = [_trace("poisson", n, s, 1.2) for s, n in enumerate((24, 6, 40, 12))]
    summ = eng.sweep(traces)
    names, jobs = {}, []
    batch = tv.stack_traces([tv.compile_trace(t, 64, names, jobs, device="cpu")[0]
                             for t in traces])
    jt = tv.build_job_table(jobs, "cpu")
    runf = tv._build_run(8, True, 64, telemetry=True)
    st_b, ms_b = runf(batch, jt, torch.full((4,), 8))
    for i, trace in enumerate(traces):
        res = eng.run(trace)
        s = res.summary()
        assert float(summ.makespan[i]) == pytest.approx(s["makespan_s"], rel=1e-6)
        assert float(summ.mean_wait[i]) == pytest.approx(s["mean_wait_s"], rel=1e-5, abs=1e-3)
        assert float(summ.p99_wait[i]) == pytest.approx(s["p99_wait_s"], rel=1e-5, abs=1e-3)
        assert float(summ.throughput[i]) == pytest.approx(s["throughput"], rel=1e-6)
        assert int(summ.dispatches[i]) == s["dispatches"]
        assert int(summ.backfills[i]) == res.backfills
        one = tv.stack_traces([tv.compile_trace(trace, 64, dict(names), list(jobs),
                                                device="cpu")[0]])
        st_1, ms_1 = runf(one, jt, torch.full((1,), 8))
        for name, a, b in zip(st_b._fields, st_b, st_1):
            assert torch.equal(a[i], b[0]), name
        for name, a, b in zip(ms_b._fields, ms_b, ms_1):
            assert torch.equal(a[i], b[0]), name


def test_capacity_overflow_raises_eagerly():
    trace = _trace("poisson", 20, 0, 1.0)
    eng = tv.VectorizedClusterSimulator(to.TimeSharingPolicy(), capacity=16, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        eng.run(trace)
    with pytest.raises(ValueError, match="capacity"):
        eng.sweep([trace])


def test_error_lanes_raise():
    check = tv.VectorizedClusterSimulator._check_err
    with pytest.raises(RuntimeError, match="ready ring"):
        check(tv.ERR_READY_OVERFLOW)
    with pytest.raises(RuntimeError, match="budget"):
        check(tv.ERR_EVENT_OVERFLOW)
    with pytest.raises(RuntimeError, match="0x4"):
        check(tv.ERR_EPISODE)
    check(0)


def test_full_ready_ring_sets_its_error_lane():
    """A window formed onto a ring with no free slot flags the lane (and a
    lane with room does not)."""
    trace = tv.stack_traces([tv.compile_trace(_trace("poisson", 8, 0, 1.0), 16,
                                              device="cpu")[0]] * 2)
    jobs = tv.build_job_table(list({a.profile.name: a.profile
                                    for a in _trace("poisson", 8, 0, 1.0)}.values()), "cpu")
    form = tv._make_form_window(trace, jobs, 4)
    run = tv._build_run(4, True, 16)
    st = run(trace, jobs, torch.full((2,), 8))
    full = torch.tensor([True, False])
    st = st._replace(pend_lo=torch.zeros(2, dtype=torch.int64),
                     pend_hi=torch.full((2,), 4),
                     r_active=full[:, None].expand(2, st.r_active.shape[1]).clone(),
                     n_groups=torch.zeros(2, dtype=torch.int64),
                     err=torch.zeros(2, dtype=torch.int64))
    out = form(st, torch.tensor([True, True]))
    assert out.err.tolist() == [tv.ERR_READY_OVERFLOW, 0]


def test_unsupported_policy_devices_and_empty():
    with pytest.raises(ValueError, match="TimeSharingPolicy or RLDispatchPolicy"):
        tv.VectorizedClusterSimulator(to.GreedyPackerPolicy(), device="cpu")
    # one device: the unsharded sweep, as the reference's fallback from pmap
    one = [_trace("poisson", 5, 0, 1.0)]
    for a, b in zip(_ts().sweep(one), _ts().sweep(one, devices=jax.devices())):
        assert torch.equal(a, b)
    res = _ts().run([])
    assert res.jobs == [] and res.makespan == 0.0
    with pytest.raises(ValueError, match="empty"):
        _ts().sweep([])


def test_default_device_is_the_card():
    """No entry point falls back to the CPU: without ``device=`` the engine
    builds its tables on the card, which this host does not have."""
    eng = tv.VectorizedClusterSimulator(to.TimeSharingPolicy())
    assert eng.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            eng.run(_trace("poisson", 5, 0, 1.0))


# ------------------------------------------------------------------ fleet

@pytest.mark.parametrize("pods", [(8, 8, 4, 4), (8, 2), (8,)])
def test_fleet_time_sharing_matches_heap(pods):
    trace = _trace("fragmented", 48, 2, 1.4, capacity=sum(pods) / 8)
    cfg = to.SimConfig(window=4, pods=pods)
    h = to.ClusterSimulator(to.TimeSharingPolicy(), cfg).run(trace)
    v = tv.VectorizedFleetSimulator(to.TimeSharingPolicy(), cfg, capacity=64,
                                    device="cpu").run(trace)
    assert_parity(h, v)
    assert v.summary() == pytest.approx(h.summary(), rel=1e-4, abs=0.05)


def test_fleet_rl_matches_heap_with_refits_and_pod_params():
    """The golden agent on a heterogeneous fleet: a group planned wider than
    a 4-unit pod decomposes (a refit), as on the heap; per-pod params that
    are all the agent's give the same result."""
    agent = load_golden_dqn(GOLDEN, "cpu")
    env = EnvConfig(window=GOLDEN_WINDOW)
    trace = _trace("fragmented", 40, 2, 1.4, capacity=3.0)
    cfg = to.SimConfig(window=GOLDEN_WINDOW, pods=(8, 8, 4, 4))
    h = to.ClusterSimulator(to.RLDispatchPolicy(agent, env), cfg).run(trace)
    tel = tv.VectorizedFleetSimulator(to.RLDispatchPolicy(agent, env), cfg, capacity=64,
                                      telemetry=True, device="cpu")
    v = tel.run(trace)
    assert_parity(h, v)
    assert h.refits > 0
    assert tel.last_metrics["wait_s"]["count"] == len(h.jobs)
    same = tv.VectorizedFleetSimulator(to.RLDispatchPolicy(agent, env), cfg, capacity=64,
                                       pod_params=[agent.params] * 4, device="cpu").run(trace)
    assert [dataclasses.asdict(r) for r in same.jobs] == [dataclasses.asdict(r) for r in v.jobs]


def test_fleet_refuses_what_the_reference_refuses():
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="hash"):
        tv.VectorizedFleetSimulator(None, to.SimConfig(pods=(8, 4), router="least_loaded"), **kw)
    with pytest.raises(ValueError, match="concurrent"):
        tv.VectorizedFleetSimulator(None, to.SimConfig(mode="blocking"), **kw)
    with pytest.raises(ValueError, match="ticks"):
        tv.VectorizedFleetSimulator(None, to.SimConfig(tick_interval_s=60.0), **kw)
    with pytest.raises(ValueError, match="pod_params"):
        tv.VectorizedFleetSimulator(None, to.SimConfig(), pod_params=[{}], **kw)
