"""The batched perfmodel and the vectorized environment of the port against
the JAX package's, on the same queues, groups and action streams.

Tolerances: the partition, fit and queue tables are equal; the perfmodel's
makespans, solo sums, r_i sums and finish times within rtol 1e-6 (the same
f32 operations; a sum of four lanes may be taken in another order);
observations and masks equal to the reference's; rewards within rtol 1e-6 /
atol 1e-4 of the JAX environment's (rewards are O(100)), and within the
reference's own bound of the scalar float64 environment (1e-3 + 2e-3 |r|,
``tests/test_vectorized_train.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import perfmodel_jax as jpm
from repro.core.env import EnvConfig as JEnvConfig
from repro.core.env import VecCoScheduleEnv as JVecEnv
from repro.core.env import _context_mask_table as jmask_table
from repro.core.partition import enumerate_partitions as jparts
from repro.core.workloads import make_queue as jmake_queue
from repro.core.workloads import make_zoo as jmake_zoo
from repro_torch.core import EnvConfig, make_queue, make_zoo
from repro_torch.core import perfmodel_vec as tpm
from repro_torch.core.env import CoScheduleEnv, VecCoScheduleEnv, _context_mask_table
from repro_torch.core.partition import enumerate_partitions
from repro_torch.core.workloads import QUEUE_KINDS

ZOO, JZOO = make_zoo(dryrun_dir=None), jmake_zoo(dryrun_dir=None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The engine's tensors are tiny; intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _queues(window, n, seed, length=None):
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = QUEUE_KINDS[i % len(QUEUE_KINDS)]
        q = make_queue(ZOO, kind, length or window, rng_t)
        jq = jmake_queue(JZOO, kind, length or window, rng_j)
        assert [j.name for j in q] == [j.name for j in jq]
        out.append((q, jq))
    return out


def _close(t, j, rtol=1e-6, atol=1e-6, what=""):
    np.testing.assert_allclose(t.float().numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j, np.float32), rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the batched perfmodel
# ---------------------------------------------------------------------------

def test_tables_and_queue_arrays_equal_the_reference():
    for c_max in (2, 3, 4):
        tt = tpm.build_partition_table(enumerate_partitions(c_max), c_max, "cpu")
        jt = jpm.build_partition_table(jparts(c_max), c_max)
        for f in tt._fields:
            np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), f)
    np.testing.assert_array_equal(tpm.build_fit_table(enumerate_partitions(3), "cpu").numpy(),
                                  np.asarray(jpm.build_fit_table(jparts(3))))
    (q, jq), = _queues(8, 1, 3, length=6)                # padded window
    qa, jqa = tpm.queue_arrays(q, 8, "cpu"), jpm.queue_arrays(jq, 8)
    for f in qa._fields:
        np.testing.assert_array_equal(getattr(qa, f).numpy(), np.asarray(getattr(jqa, f)), f)
    jt, tt = jpm.job_terms_table(JZOO[:5]), tpm.job_terms_table(ZOO[:5], "cpu")
    for f in tt._fields:
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)), f)
    np.testing.assert_array_equal(_context_mask_table(), np.asarray(jmask_table()))


def test_water_fill_matches_jax():
    rng = np.random.default_rng(0)
    for S in (1, 3, 4, 6):
        d = rng.random((200, S)).astype(np.float32) * rng.choice([0.3, 1.0, 3.0], (200, 1))
        d[:20] = 1.0 / S                                  # exact fair shares
        act = rng.random((200, S)) < 0.7
        ref = jax.vmap(jpm.water_fill_vec)(jnp.asarray(d), jnp.asarray(act))
        out = tpm.water_fill_vec(torch.from_numpy(d), torch.from_numpy(act))
        _close(out, ref, what=f"S={S}")


@pytest.mark.parametrize("window,c_max,length", [(8, 4, 8), (6, 3, 4), (5, 2, 5)])
def test_group_metrics_and_reward_match_jax(window, c_max, length):
    """Random groups (any selection order, padded windows) under random
    partitions of matching arity, and the right-sized width override."""
    parts = enumerate_partitions(c_max)
    tt = tpm.build_partition_table(parts, c_max, "cpu")
    jt = jpm.build_partition_table(jparts(c_max), c_max)
    arity = np.asarray([p.arity for p in parts])
    rng = np.random.default_rng(window * 10 + c_max)
    for q, jq in _queues(window, 3, window + c_max, length):
        B = 48
        p_idx = rng.integers(0, len(parts), B)
        size = arity[p_idx]
        gidx = np.full((B, c_max), -1, np.int32)
        for b in range(B):
            gidx[b, :size[b]] = rng.permutation(length)[:size[b]]
        units = rng.integers(0, 4, (B, c_max)).astype(np.int32)
        qa = tpm.stack_queues([tpm.queue_arrays(q, window, "cpu")] * B)
        jqa = jpm.queue_arrays(jq, window)
        args = [torch.from_numpy(gidx).long(), torch.from_numpy(size).long(),
                torch.from_numpy(p_idx)]
        jargs = [jnp.asarray(gidx), jnp.asarray(size.astype(np.int32)), jnp.asarray(p_idx)]
        got = tpm.group_metrics(tt, qa, *args, with_finish=True)
        ref = _jax_metrics(jt, jqa, *jargs, None)
        for name, a, b in zip(("makespan", "solo", "ri", "finish"), got, ref):
            _close(a, b, atol=0, what=name)
        makespan, solo, ri = got[:3]
        got = tpm.group_metrics(tt, qa, *args, units_idx=torch.from_numpy(units).long(),
                                with_finish=True)
        ref = _jax_metrics(jt, jqa, *jargs, jnp.asarray(units))
        for name, a, b in zip(("makespan", "solo", "ri", "finish"), got, ref):
            _close(a, b, atol=0, what=f"{name} (right-sized)")
        r = tpm.group_reward(tt, qa, *args, 0.2, 100.0)
        _close(r, tpm.close_reward(makespan, solo, ri, 0.2, 100.0), rtol=0, atol=0)
        jr = jax.vmap(jpm.group_reward, in_axes=(None, None, 0, 0, 0, None, None))(
            jt, jqa, *jargs, 0.2, 100.0)
        _close(r, jr, rtol=1e-6, atol=1e-4, what="reward")


@jax.jit
def _jax_metrics(jt, jqa, g, s, p, u):
    """The reference's group_metrics over a batch of groups (one compile per
    shape: the tables are arguments, not constants)."""
    if u is None:
        return jax.vmap(lambda g, s, p: jpm.group_metrics(jt, jqa, g, s, p, with_finish=True))(
            g, s, p)
    return jax.vmap(lambda g, s, p, u: jpm.group_metrics(jt, jqa, g, s, p, units_idx=u,
                                                         with_finish=True))(g, s, p, u)


# ---------------------------------------------------------------------------
# the vectorized environment
# ---------------------------------------------------------------------------

def _rollout(env_cfg, jenv_cfg, pairs, seed, ctx=False):
    """B envs stepped with one action stream through the port, the JAX
    vectorized env and (without context) the port's scalar env."""
    venv, jvenv = VecCoScheduleEnv(env_cfg, "cpu"), JVecEnv(jenv_cfg)
    B = len(pairs)
    qa = venv.queue_batch([q for q, _ in pairs])
    jqa = jvenv.queue_batch([jq for _, jq in pairs])
    if ctx:
        key = jax.random.PRNGKey(seed)
        jctx = jvenv.sample_context(key, jqa.mean_d, jqa.valid)
        k_m, k_a, k_d = jax.random.split(key, 3)          # sample_context's split
        draws = (np.array(jax.random.randint(k_m, (B,), 0, 64)),
                 np.array(jax.random.exponential(k_a, jqa.valid.shape, dtype=jnp.float32)),
                 np.array(jax.random.exponential(k_d, (B,), dtype=jnp.float32)))
        tctx = venv.sample_context(None, qa.mean_d, qa.valid, draws=draws)
        for a, b in zip(tctx, jctx):
            _close(a, b, what="context")
        st, obs, mask = venv.reset_batch_ctx(qa, tctx)
        jst, jobs_, jmask = jvenv.reset_batch_ctx(jqa, jctx)
    else:
        st, obs, mask = venv.reset_batch(qa)
        jst, jobs_, jmask = jvenv.reset_batch(jqa)
        refs = [CoScheduleEnv(env_cfg) for _ in range(B)]
        for ref, (q, _) in zip(refs, pairs):
            ref.reset(q)
    rng = np.random.default_rng(seed)
    done = np.zeros(B, bool)
    for t in range(3 * env_cfg.window):
        _close(obs, jobs_, what=f"obs step {t}")
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        m = mask.numpy()
        a = np.array([rng.choice(np.flatnonzero(m[b])) if m[b].any() else 0 for b in range(B)])
        if t == 2:
            a[0] = env_cfg.window + len(venv.partitions) - 1   # an invalid close: penalty
        a_t = torch.from_numpy(a)
        mk, so, multi = venv.close_metrics_batch(st, a_t)
        jmk, jso, jmulti = jvenv.close_metrics_batch(jst, jnp.asarray(a, jnp.int32))
        _close(mk, jmk, what="close makespan")
        _close(so, jso, what="close solo")
        np.testing.assert_array_equal(multi.numpy(), np.asarray(jmulti))
        st, obs, r, d, mask = venv.step_batch(st, a_t)
        jst, jobs_, jr, jd, jmask = jvenv.step_batch(jst, jnp.asarray(a, jnp.int32))
        _close(r, jr, rtol=1e-6, atol=1e-4, what=f"reward step {t}")
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        if not ctx:
            for b, ref in enumerate(refs):
                if done[b]:
                    continue
                _, r_ref, d_ref, m_ref, _ = ref.step(int(a[b]))
                assert abs(float(r[b]) - r_ref) <= 1e-3 + 2e-3 * abs(r_ref), (t, b)
                assert bool(d[b]) == d_ref
                np.testing.assert_array_equal(mask[b].numpy(), m_ref)
        done |= d.numpy()
    assert done.all()


@pytest.mark.parametrize("window,c_max,length", [(6, 4, 6), (8, 3, 5)])
def test_vec_env_rollout_matches_jax_and_scalar_env(window, c_max, length):
    pairs = _queues(window, 6, window * c_max, length)
    _rollout(EnvConfig(window=window, c_max=c_max), JEnvConfig(window=window, c_max=c_max),
             pairs, window)


def test_vec_env_context_rollout_matches_jax():
    pairs = _queues(6, 6, 11)
    _rollout(EnvConfig(window=6, c_max=4, obs_context=True),
             JEnvConfig(window=6, c_max=4, obs_context=True), pairs, 5, ctx=True)
