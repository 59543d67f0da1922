"""Training the moe family in the port against the reference, in f32 on
the smoke configs (``tests/torch_train_parity.py``: tolerances of
``test_torch_lm_train.py``, the reference's weights carried across):
gradients through the f32 router, ``load_balance_loss``, ``moe_z``, the
sort-based dispatch and the combine, with the reference's shared experts
(qwen2-moe-a2.7b: 6 routed top-2, 2 shared) and with tokens dropped
(deepseek-moe-16b at capacity factor 0.5: a dropped slot's gradient must
reach nothing).  Three JAX compiles.

Under block remat each MoE layer's dispatch runs twice, in the forward and
in the backward's recompute: both must keep the same slots.  Parameters
and master weights after a step are held to ``STEP_TOL`` (the reason and
the measured values are in ``torch_train_parity.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.models import moe as tmoe
from torch_train_parity import (
    check_loss_and_grads, check_three_steps, cfgs, make_batch, port_loss_and_grads,
    port_params, reference_params,
)

CASES = {"shared_experts": ("qwen2-moe-a2.7b", None), "dropped": ("deepseek-moe-16b", 0.5)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_reference(case):
    arch, cap = CASES[case]
    jcfg, tcfg = cfgs(arch, capacity_factor=cap)
    metrics = check_loss_and_grads(jcfg, tcfg, make_batch(jcfg, 2, 24, seed=1))
    if case == "dropped":     # summed over the 2 MoE layers, more than a third dropped
        assert metrics["moe_drop_frac"].item() > 0.3
    else:
        assert 0 < metrics["moe_drop_frac"].item() < 0.3


def test_three_train_steps_match_reference():
    jcfg, tcfg = cfgs("deepseek-moe-16b", capacity_factor=0.5)
    mets = check_three_steps(jcfg, tcfg, make_batch(jcfg, 2, 24, seed=2))
    assert all(m["moe_drop_frac"].item() > 0.3 for m in mets)


def test_remat_recomputes_the_same_dispatch(monkeypatch):
    """Block remat against none at capacity factor 0.5: each layer's
    recomputed dispatch keeps the slots its forward kept, and the loss and
    gradients are those of the run that stores its activations."""
    jcfg, tcfg = cfgs("deepseek-moe-16b", capacity_factor=0.5)
    jp, batch = reference_params(jcfg), make_batch(jcfg, 2, 24, seed=3)
    calls = []
    dispatch = tmoe.dispatch

    def recording(ids, n_experts, cap):
        out = dispatch(ids, n_experts, cap)
        calls.append((ids.clone(), out[3].clone()))
        return out

    monkeypatch.setattr(tmoe, "dispatch", recording)
    out = {}
    for remat in ("block", "none"):
        cfg = tcfg.replace(remat=remat)
        calls.clear()
        out[remat] = port_loss_and_grads(port_params(jp, cfg), batch, cfg)
        n = cfg.n_layers
        if remat == "block":      # forward layers 0..n-1, then the recompute from n-1 down
            assert len(calls) == 2 * n
            for i in range(n):
                ids, keep = calls[i]
                ids2, keep2 = calls[2 * n - 1 - i]
                assert torch.equal(ids, ids2) and torch.equal(keep, keep2)
                assert not keep.all()
        else:
            assert len(calls) == n
    assert out["block"][0].item() == out["none"][0].item()
    for a, b in zip(out["block"][2], out["none"][2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-8)
