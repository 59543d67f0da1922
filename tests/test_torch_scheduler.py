"""With the golden trained agent, the port's RL scheduler produces the same
schedules as the reference: same groups (job names, slot order) and the
same partition labels; placements and the submission protocol agree too."""
import copy
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import env as jenv
from repro.core import scheduler as jsched
from repro.core import workloads as jwork
from repro.core.agent import DQNAgent as JAgent
from repro.core.profiles import ProfileRepository as JRepo
from repro_torch.convert import DQN_KEYS, GOLDEN_WINDOW, load_golden_dqn
from repro_torch.core import env as tenv
from repro_torch.core import scheduler as tsched
from repro_torch.core import workloads as twork
from repro_torch.core.profiles import ProfileRepository as TRepo

GOLDEN = pathlib.Path(__file__).parent / "golden" / "train_agent_proxy_v1.npz"
ZOO_J = jwork.make_zoo(dryrun_dir=None)
ZOO_T = twork.make_zoo(dryrun_dir=None)


def _schedulers():
    ja = JAgent(48, 25, seed=0)
    with np.load(GOLDEN) as z:
        ja.params = {k: jnp.asarray(z[f"param_{i}"]) for i, k in enumerate(DQN_KEYS)}
    ta = load_golden_dqn(GOLDEN, "cpu")
    return (jsched.RLScheduler(ja, jenv.EnvConfig(window=GOLDEN_WINDOW)),
            tsched.RLScheduler(ta, tenv.EnvConfig(window=GOLDEN_WINDOW)))


SCHED_J, SCHED_T = _schedulers()


def _plan(sched):
    return ([[j.name for j in g] for g in sched.groups], [p.label for p in sched.partitions])


def _check(queue_j, queue_t):
    sj, st = SCHED_J.schedule(queue_j), SCHED_T.schedule(queue_t)
    assert _plan(st) == _plan(sj)
    return sj, st


@pytest.mark.parametrize("qname", [f"Q{i}" for i in range(1, 13)])
def test_paper_queue_schedules(qname):
    qj = jwork.paper_queues(ZOO_J, window=GOLDEN_WINDOW)[qname]
    qt = twork.paper_queues(ZOO_T, window=GOLDEN_WINDOW)[qname]
    _check(qj, qt)


@pytest.mark.parametrize("kind", ["ci", "mi", "us", "balanced"])
@pytest.mark.parametrize("seed", [3, 17])
def test_make_queue_schedules(kind, seed):
    qj = jwork.make_queue(ZOO_J, kind, GOLDEN_WINDOW, np.random.default_rng(seed))
    qt = twork.make_queue(ZOO_T, kind, GOLDEN_WINDOW, np.random.default_rng(seed))
    assert [j.name for j in qt] == [j.name for j in qj]
    _check(qj, qt)


def test_to_placements_with_width_hints():
    units = [1, 2, 4, 8]
    qj = [copy.deepcopy(j) for j in jwork.paper_queues(ZOO_J, window=GOLDEN_WINDOW)["Q2"]]
    qt = [copy.deepcopy(j) for j in twork.paper_queues(ZOO_T, window=GOLDEN_WINDOW)["Q2"]]
    for i, (a, b) in enumerate(zip(qj, qt)):
        a.meta["units"] = b.meta["units"] = units[i % len(units)]
    sj, st = _check(qj, qt)
    pj, pt = jsched.to_placements(sj), tsched.to_placements(st)
    assert [([j.name for j in p.group], p.partition.label) for p in pt] == [
        ([j.name for j in p.group], p.partition.label) for p in pj]


def test_submission_protocol_first_sight_and_chunking():
    zj, zt = ZOO_J[:10], ZOO_T[:10]
    rj, rt = JRepo(), TRepo()
    for a, b in zip(zj[:6], zt[:6]):
        rj.insert(a.name, a)
        rt.insert(b.name, b)
    subs_j = [(j.name, j) for j in zj]            # 4 first sights, 6 profiled
    subs_t = [(j.name, j) for j in zt]
    seen_j, seen_t = [], []
    out_j = jsched.submission_protocol(rj, subs_j, SCHED_J.schedule, window=GOLDEN_WINDOW,
                                       on_window=lambda c: seen_j.append(len(c)))
    out_t = tsched.submission_protocol(rt, subs_t, SCHED_T.schedule, window=GOLDEN_WINDOW,
                                       on_window=lambda c: seen_t.append(len(c)))
    assert _plan(out_t) == _plan(out_j)
    assert seen_t == seen_j == [4, 2]
    assert len(rt) == len(rj) == 10
