"""The port's DQN forward, greedy action and input widening against the
reference, on random observations and on the golden trained agent."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import network as jnet
from repro_torch.convert import DQN_KEYS, dqn_params_from_numpy
from repro_torch.core import network as tnet

GOLDEN = pathlib.Path(__file__).parent / "golden" / "train_agent_proxy_v1.npz"


def _golden() -> dict:
    with np.load(GOLDEN) as z:
        return {k: z[f"param_{i}"] for i, k in enumerate(DQN_KEYS)}


def _random_params(rng, in_dim, n_actions) -> dict:
    dims = (in_dim, *jnet.HIDDEN)
    p = {}
    for i in range(len(jnet.HIDDEN)):
        p[f"w{i}"] = rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) / np.sqrt(dims[i])
        p[f"b{i}"] = 0.1 * rng.standard_normal(dims[i + 1]).astype(np.float32)
    p["wV"] = rng.standard_normal((dims[-1], 1)).astype(np.float32) / np.sqrt(dims[-1])
    p["bV"] = rng.standard_normal(1).astype(np.float32)
    p["wA"] = rng.standard_normal((dims[-1], n_actions)).astype(np.float32) / np.sqrt(dims[-1])
    p["bA"] = 0.1 * rng.standard_normal(n_actions).astype(np.float32)
    return p


def _obs_mask(rng, n, in_dim, n_actions):
    obs = rng.uniform(0.0, 1.0, (n, in_dim)).astype(np.float32)
    mask = rng.uniform(size=(n, n_actions)) < 0.5
    mask[:, 0] |= ~mask.any(axis=1)
    return obs, mask


@pytest.mark.parametrize("source", ["golden", "random48", "random96"])
def test_dqn_apply_and_greedy_action(source):
    rng = np.random.default_rng(len(source))
    if source == "golden":
        np_params, in_dim, n_actions = _golden(), 48, 25
    else:
        in_dim = int(source[6:])
        n_actions = in_dim // 2 + 21
        np_params = _random_params(rng, in_dim, n_actions)
    obs, mask = _obs_mask(rng, 64, in_dim, n_actions)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    tp = dqn_params_from_numpy(np_params, "cpu")
    qj = np.asarray(jnet.dqn_apply(jp, jnp.asarray(obs)))
    qt = tnet.dqn_apply(tp, torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(qt, qj, atol=1e-5, rtol=1e-5)
    for o, m, q in zip(obs, mask, qj):
        a_j = int(jnet.greedy_q_action(jp, jnp.asarray(o), jnp.asarray(m)))
        a_t = int(tnet.greedy_q_action(tp, torch.from_numpy(o), torch.from_numpy(m)))
        top2 = np.sort(q[m])[-2:]
        assert a_t == a_j, f"actions {a_t} vs {a_j}, top-2 gap {top2[-1] - top2[0]:.3e}"


def test_masked_argmax_first_maximum_wins():
    q = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0], [0.0, 9.0, 9.0, 9.0]])
    mask = torch.tensor([[True, True, True, True], [False, True, True, True],
                         [True, False, True, True]])
    got = tnet.masked_argmax(q, mask).tolist()
    want = np.asarray(jnet.masked_argmax(jnp.asarray(q.numpy()), jnp.asarray(mask.numpy())))
    assert got == want.tolist() == [1, 1, 2]


@pytest.mark.parametrize("extra", [0, 13])
def test_widen_dqn_params(extra):
    np_params = _golden()
    jw = jnet.widen_dqn_params({k: jnp.asarray(v) for k, v in np_params.items()}, extra)
    tw = tnet.widen_dqn_params(dqn_params_from_numpy(np_params, "cpu"), extra)
    assert set(jw) == set(tw)
    for k in jw:
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]))
    obs = np.random.default_rng(1).uniform(size=(8, 48)).astype(np.float32)
    wide = np.concatenate([obs, np.zeros((8, extra), np.float32)], axis=1)
    base = tnet.dqn_apply(dqn_params_from_numpy(np_params, "cpu"), torch.from_numpy(obs))
    torch.testing.assert_close(tnet.dqn_apply(tw, torch.from_numpy(wide)), base)


def test_init_dqn_shapes_and_seed():
    p1 = tnet.init_dqn(torch.Generator().manual_seed(0), 48, 25, device="cpu")
    p2 = tnet.init_dqn(torch.Generator().manual_seed(0), 48, 25, device="cpu")
    ref = jnet.init_dqn(jax.random.PRNGKey(0), 48, 25)
    assert {k: tuple(v.shape) for k, v in p1.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    for k in p1:
        assert torch.equal(p1[k], p2[k])
