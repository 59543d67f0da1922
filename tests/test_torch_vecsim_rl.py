"""The port's vectorized simulator, RL serving and training rollouts.

The golden agent of ``tests/golden/train_agent_proxy_v1.npz`` (window 4)
serves in the port's engine, held against the port's heap RL policy (which
``tests/test_torch_online.py`` holds to the reference's): decisions
exactly, times to f32 resolution.  Two cases go through the JAX package
(two compiled programs): the RL engine on one trace, and the rollout
collector at ε = 0.3 fed the reference's own ``jax.random`` draws (split as
``repro/online/vecsim.py`` splits them), where actions, masks, valid flags
and observations must be equal and the queueing buckets equal within f32.
Everything runs on the CPU at small sizes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import online as jo
from repro.core import make_zoo as jzoo
from repro.core.agent import DQNAgent as JAgent
from repro.core.env import EnvConfig as JEnvConfig
from repro.online import vecsim as jv
from repro_torch import online as to
from repro_torch.convert import DQN_KEYS, GOLDEN_WINDOW, load_golden_dqn
from repro_torch.core import make_zoo
from repro_torch.core.agent import DQNAgent
from repro_torch.core.env import EnvConfig
from repro_torch.core.network import widen_dqn_params
from repro_torch.online import vecsim as tv
from test_torch_vecsim import assert_parity, close

GOLDEN = "tests/golden/train_agent_proxy_v1.npz"
ZOO = make_zoo(dryrun_dir=None)
ENV = EnvConfig(window=GOLDEN_WINDOW)
AGENT = load_golden_dqn(GOLDEN, "cpu")
_ENGINES: dict = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The engine is thousands of small ops: one intra-op thread does them as
    fast as eight and leaves the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden_j():
    agent = JAgent(48, 25, seed=0)
    with np.load(GOLDEN) as z:
        agent.params = {k: jnp.asarray(z[f"param_{i}"]) for i, k in enumerate(DQN_KEYS)}
    return agent


def _rl(window=GOLDEN_WINDOW, backfill=True, capacity=96):
    key = (window, backfill, capacity)
    if key not in _ENGINES:
        _ENGINES[key] = tv.VectorizedClusterSimulator(
            to.RLDispatchPolicy(AGENT, ENV), window=window, backfill=backfill,
            capacity=capacity, device="cpu")
    return _ENGINES[key]


def _heap(trace, window=GOLDEN_WINDOW, backfill=True, agent=AGENT, env=ENV):
    return to.ClusterSimulator(to.RLDispatchPolicy(agent, env), window=window,
                               backfill=backfill).run(trace)


def _trace(fam, n, seed, load):
    return to.TRACE_FAMILIES[fam](ZOO, n=n, load=load, seed=seed)


_RNG = np.random.default_rng(77)
SPECS = [(str(_RNG.choice(sorted(to.TRACE_FAMILIES))), int(_RNG.integers(5, 41)),
          int(_RNG.integers(0, 51)), float(_RNG.uniform(0.5, 1.8))) for _ in range(6)]


@pytest.mark.parametrize("spec", SPECS, ids=[f"{f}-{n}-{s}" for f, n, s, _ in SPECS])
def test_rl_matches_heap_on_random_traces(spec):
    trace = _trace(*spec)
    h = _heap(trace)
    assert_parity(h, _rl().run(trace))


@pytest.mark.parametrize("window,backfill", [(2, True), (1, True), (4, False)])
def test_rl_matches_heap_across_engine_knobs(window, backfill):
    trace = _trace("fragmented", 30, 4, 1.5)
    assert_parity(_heap(trace, window, backfill), _rl(window, backfill).run(trace))


def test_rl_backfill_heavy_and_grouped():
    """Overloaded fragmented traces: the agent groups jobs and the EASY scan
    backfills multi-slice entries, as on the heap."""
    grouped = backfills = 0
    for seed in (0, 1):
        trace = _trace("fragmented", 40, seed, 1.6)
        h = _heap(trace)
        assert_parity(h, _rl().run(trace))
        grouped += sum(r.group_size > 1 for r in h.jobs)
        backfills += h.backfills
    assert grouped > 0 and backfills > 0


def test_rl_duplicate_tenants_in_one_window():
    """Same-instant bursts of one binary: the entries' arrivals follow the
    heap's name-keyed FIFO."""
    trace, t = [], 0.0
    for i, (j, reps) in enumerate(((3, 3), (5, 2), (3, 2), (9, 4))):
        t += 150.0 * i
        trace += [to.Arrival(t=t, binary=f"bin://{ZOO[j].name}", profile=ZOO[j])] * reps
    trace += [to.Arrival(t=t, binary=f"bin://{ZOO[1].name}", profile=ZOO[1])]
    assert_parity(_heap(trace), _rl().run(trace))


def test_rl_obs_context_agent_matches_heap():
    """An arrival-aware agent (the golden weights widened with zero context
    rows) sees the f32 context block in the engine and the f64 snapshot on
    the heap; with zero context weights its decisions must agree."""
    env = EnvConfig(window=GOLDEN_WINDOW, obs_context=True)
    extra = 8 + GOLDEN_WINDOW + 1
    agent = DQNAgent(48 + extra, 25, device="cpu", params=widen_dqn_params(AGENT.params, extra))
    trace = _trace("poisson", 30, 5, 1.4)
    h = _heap(trace, agent=agent, env=env)
    v = tv.VectorizedClusterSimulator(to.RLDispatchPolicy(agent, env), window=GOLDEN_WINDOW,
                                      capacity=64, device="cpu").run(trace)
    assert_parity(h, v)


def test_rl_matches_the_jax_engine():
    """The golden agent at ``GOLDEN_WINDOW`` on one trace in both engines
    (one compile): records and timeline equal, times within rtol 1e-6, the
    same telemetry."""
    kw = dict(window=GOLDEN_WINDOW, capacity=64, telemetry=True)
    trj = jo.TRACE_FAMILIES["fragmented"](jzoo(dryrun_dir=None), n=40, load=1.5, seed=1)
    trt = _trace("fragmented", 40, 1, 1.5)
    ej = jo.VectorizedClusterSimulator(jo.RLDispatchPolicy(_golden_j(),
                                                           JEnvConfig(window=GOLDEN_WINDOW)), **kw)
    et = tv.VectorizedClusterSimulator(to.RLDispatchPolicy(AGENT, ENV), device="cpu", **kw)
    rj, rt = ej.run(trj), et.run(trt)
    assert sum(r.group_size > 1 for r in rj.jobs) > 0 and rj.backfills > 0
    for a, b in zip(rj.jobs, rt.jobs):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in ("dispatch", "finish"):
            assert b.pop(k) == pytest.approx(a.pop(k), rel=1e-6)
        assert a == b
    assert [dataclasses.asdict(s) for s in rj.timeline] == \
        pytest.approx([dataclasses.asdict(s) for s in rt.timeline], rel=1e-6)
    assert (rj.refits, rj.dispatches, rj.backfills) == (rt.refits, rt.dispatches, rt.backfills)
    assert ej.last_metrics["wait_s"]["counts"] == et.last_metrics["wait_s"]["counts"]
    assert et.last_metrics["wait_s"]["sum"] == pytest.approx(ej.last_metrics["wait_s"]["sum"],
                                                             rel=1e-6)


def test_sweep_and_param_sets_rows_match_single_runs():
    """A sweep's lanes equal single-trace runs; ``param_sets`` scores P
    agents x T traces in one call, each agent's rows equal to its own
    single-agent sweep."""
    eng = _rl(capacity=64)
    traces = [_trace("poisson", n, s, 1.2) for s, n in enumerate((20, 6, 24))]
    summ = eng.sweep(traces)
    for i, trace in enumerate(traces):
        s = eng.run(trace).summary()
        assert close(float(summ.makespan[i]), s["makespan_s"])
        assert close(float(summ.mean_wait[i]), s["mean_wait_s"])
        assert close(float(summ.p99_wait[i]), s["p99_wait_s"])
        assert int(summ.dispatches[i]) == s["dispatches"]
    g = torch.Generator().manual_seed(0)
    pop = [AGENT.params] + [{k: v + 0.2 * torch.randn(v.shape, generator=g)
                             for k, v in AGENT.params.items()} for _ in range(2)]
    out = eng.sweep(traces, param_sets=pop)
    assert out.makespan.shape == (3, 3)
    for p_i, params in enumerate(pop):
        one = tv.VectorizedClusterSimulator(
            to.RLDispatchPolicy(load_golden_dqn(GOLDEN, "cpu"), ENV), window=GOLDEN_WINDOW,
            capacity=64, device="cpu")
        one.policy.agent.params = params
        for name, a, b in zip(out._fields, out, one.sweep(traces)):
            assert torch.equal(a[p_i], b), name
    # the perturbed agents serve differently
    assert any(not torch.equal(out.mean_wait[0], out.mean_wait[p]) for p in (1, 2))
    with pytest.raises(ValueError, match="exclusive"):
        tv.VectorizedClusterSimulator(to.RLDispatchPolicy(AGENT, ENV), window=GOLDEN_WINDOW,
                                      telemetry=True, device="cpu").sweep(
            traces, with_metrics=True, param_sets=pop)


def test_agent_on_another_device_raises():
    """The engine runs on its agent's device: nothing moves quietly."""
    with pytest.raises(ValueError, match="agent lives on"):
        tv.VectorizedClusterSimulator(to.RLDispatchPolicy(AGENT, ENV), window=GOLDEN_WINDOW,
                                      device="meta")
    with pytest.raises(ValueError, match="sim window"):
        tv.VectorizedClusterSimulator(to.RLDispatchPolicy(AGENT, ENV), window=8, device="cpu")


# -------------------------------------------------------- training rollouts

def _batch(traces, capacity):
    names, jobs = {}, []
    batch = tv.stack_traces([tv.compile_trace(t, capacity, names, jobs, device="cpu")[0]
                             for t in traces])
    return batch, tv.build_rl_job_table(jobs, "cpu")


def _bucket_totals(roll, lane):
    return float(roll.w_wait[lane].double().sum()), float(roll.w_turn[lane].double().sum())


def test_collector_eps0_reproduces_serving_and_buckets_sum_to_heap_totals():
    """At ε = 0 the rollout's decisions are the serving engine's; its
    per-window buckets sum to the heap's wait and turnaround totals."""
    traces = [_trace("fragmented", 30, s, 1.5) for s in (0, 3)]
    batch, rjt = _batch(traces, 64)
    collect = tv.make_rollout_collector(ENV, window=GOLDEN_WINDOW, capacity=64, device="cpu")
    summ, roll = collect(batch, rjt, AGENT.params, 0.0, torch.full((2,), 8),
                         generator=torch.Generator().manual_seed(1))
    serve = _rl(capacity=64).sweep(traces)
    for a, b in zip(summ, serve):
        assert torch.equal(a, b)
    for lane, trace in enumerate(traces):
        h = _heap(trace)
        wait, turn = _bucket_totals(roll, lane)
        n = len(trace)
        assert wait == pytest.approx(sum(r.wait for r in h.jobs), rel=1e-4, abs=0.05 * n)
        assert turn == pytest.approx(sum(r.turnaround for r in h.jobs), rel=1e-4, abs=0.05 * n)
        nw = int(summ.dispatches[lane])
        assert roll.valid[lane, :nw].any() and not roll.valid[lane, nw:].any()
        assert torch.all(roll.w_wait[lane, nw:] == 0)


def test_collector_matches_the_jax_collector_on_its_draws():
    """ε = 0.3 with the reference's draws: step t of window w of lane b
    explores iff ``uniform(ka) < eps`` and takes the valid action of largest
    ``uniform(kb, (W+P,))``, ``ka, kb = split(fold_in(fold_in(key_b, w), t))``."""
    W, cap, B, eps = GOLDEN_WINDOW, 64, 3, 0.3
    tj = [jo.TRACE_FAMILIES["poisson"](jzoo(dryrun_dir=None), n=30, load=1.3, seed=s)
          for s in range(B)]
    names, jobs = {}, []
    cj = [jv.compile_trace(t, cap, names, jobs)[0] for t in tj]
    bj = jax.tree.map(lambda *xs: jnp.stack(xs), *cj)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    colj = jv.make_rollout_collector(JEnvConfig(window=W), window=W, capacity=cap)
    sj, rj = colj(bj, jv.build_rl_job_table(jobs), _golden_j().params, keys, jnp.float32(eps),
                  jnp.full((B,), 8, jnp.int32))
    n_act, t_ep = 25, 2 * W

    def draws(key):
        def one(w, t):
            ka, kb = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, w), t))
            return jax.random.uniform(ka, ()), jax.random.uniform(kb, (n_act,))
        return jax.vmap(lambda w: jax.vmap(lambda t: one(w, t))(jnp.arange(t_ep)))(
            jnp.arange(cap))

    ue, us = jax.vmap(draws)(keys)
    batch, rjt = _batch([_trace("poisson", 30, s, 1.3) for s in range(B)], cap)
    colt = tv.make_rollout_collector(ENV, window=W, capacity=cap, device="cpu")
    st, rt = colt(batch, rjt, AGENT.params, eps, torch.full((B,), 8),
                  u_explore=torch.tensor(np.array(ue)), u_scores=torch.tensor(np.array(us)))
    valid = np.asarray(rj.valid)
    assert valid.sum() > 0 and (rt.valid.numpy() == valid).all()
    assert (rt.act.numpy() == np.asarray(rj.act)).all()
    assert (rt.mask.numpy() == np.asarray(rj.mask)).all()
    np.testing.assert_array_equal(rt.obs.numpy(), np.asarray(rj.obs))
    # some decision steps explored
    assert (np.asarray(ue)[valid] < eps).any()
    for f in ("w_wait", "w_turn"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                   rtol=1e-6, atol=1e-3)
    for name, a, b in zip(st._fields, st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, err_msg=name)
