"""The port's co-residency executors against the reference's with trivial
counter tenants: the same quanta, steps done and finishing order."""
import jax.numpy as jnp
import pytest
import torch

from repro.runtime import multitenant as jmt
from repro_torch.runtime import multitenant as tmt

CASES = [  # shares, total steps, quanta_per_cycle
    ((0.75, 0.25), (12, 8), 4),
    ((0.5, 0.5), (6, 6), 2),
    ((0.1, 0.3, 0.6), (5, 9, 30), 4),
    ((1.0,), (7,), 4),
    ((0.2, 0.8), (40, 3), 3),
]


def _tenants(mod, shares, make_state):
    return [mod.Tenant(f"t{i}", lambda s: s + 1, make_state(), share)
            for i, share in enumerate(shares)]


def _order(finish):
    return sorted(finish, key=lambda n: (finish[n], n))


@pytest.mark.parametrize("shares,steps,qpc", CASES)
def test_fused_corunner_matches_reference(shares, steps, qpc):
    total = {f"t{i}": n for i, n in enumerate(steps)}
    jt = _tenants(jmt, shares, lambda: jnp.zeros((), jnp.int32))
    tt = _tenants(tmt, shares, lambda: torch.zeros((), dtype=torch.int32))
    jr, tr = jmt.FusedCoRunner(jt, total, qpc), tmt.FusedCoRunner(tt, total, qpc)
    assert tr.quanta == jr.quanta
    jf, tf = jr.run(), tr.run()
    assert [t.steps_done for t in tt] == [t.steps_done for t in jt]
    assert set(tf) == set(jf) == set(total)
    # tenants that finish in one macro-step share its finish time on both
    # sides, so ties break by name
    assert _order(tf) == _order(jf)
    macros = {t.name: -(-total[t.name] // q) for t, q in zip(tt, tr.quanta)}
    assert _order(tf) == sorted(total, key=lambda n: (macros[n], n))
    # a finished tenant is not stepped again (the reference keeps stepping it)
    assert [int(t.state) for t in tt] == [t.steps_done for t in tt]
    assert all(int(j.state) >= t.steps_done for j, t in zip(jt, tt))


@pytest.mark.parametrize("shares,steps,qpc", CASES)
def test_quantum_executor_matches_reference(shares, steps, qpc):
    total = {f"t{i}": n for i, n in enumerate(steps)}
    jt = _tenants(jmt, shares, lambda: jnp.zeros((), jnp.int32))
    tt = _tenants(tmt, shares, lambda: torch.zeros((), dtype=torch.int32))
    # the straggler rule reads the wall clock; an infinite factor turns it off
    # so both runs are deterministic
    je = jmt.QuantumExecutor(jt, total, straggler_factor=float("inf"))
    te = tmt.QuantumExecutor(tt, total, straggler_factor=float("inf"))
    assert te._quanta() == je._quanta()
    jf, tf = je.run(), te.run()
    assert [t.steps_done for t in tt] == [t.steps_done for t in jt]
    assert [int(t.state) for t in tt] == [int(t.state) for t in jt]
    assert set(tf) == set(jf)
    assert te.events == je.events == []
