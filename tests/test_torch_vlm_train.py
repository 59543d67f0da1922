"""Training the vlm family (Chameleon) in the port against the reference,
in f32 on chameleon-34b's smoke config (4/2 heads; ``tests/
torch_train_parity.py``: tolerances of ``test_torch_lm_train.py``, the
reference's weights carried across).

The gradient runs through the QK-norm after RoPE (``layers.py: qk_norm``,
per-head RMS in f32).  In both packages the QK-norm has no learnable scale,
so what it adds to the backward is the normalization's Jacobian on the way
to ``wq`` and ``wk``.  Two JAX compiles.
Parameters and master weights after a step are held to ``STEP_TOL``
(the reason and the measured values are in ``torch_train_parity.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.layers import qk_norm as j_qk_norm
from repro_torch.models.layers import qk_norm as t_qk_norm
from torch_train_parity import (
    GRAD_TOL, check_loss_and_grads, check_three_steps, cfgs, make_batch,
)

ARCH = "chameleon-34b"


def test_loss_and_grads_match_reference():
    jcfg, tcfg = cfgs(ARCH)
    assert tcfg.family == "vlm"
    check_loss_and_grads(jcfg, tcfg, make_batch(jcfg, 2, 40, seed=1))


def test_three_train_steps_match_reference():
    jcfg, tcfg = cfgs(ARCH)
    check_three_steps(jcfg, tcfg, make_batch(jcfg, 2, 32, seed=2))


def test_qk_norm_grad_matches_reference():
    """The QK-norm's own vector-Jacobian product at heads of 16 and 128,
    with rows of very different scales (eager, no compile of a model)."""
    rng = np.random.default_rng(3)
    for d in (16, 128):
        x = (rng.standard_normal((2, 5, 4, d)) * rng.uniform(1e-2, 10, (2, 5, 4, 1))).astype(
            np.float32)
        w = rng.standard_normal(x.shape).astype(np.float32)
        ref = jax.grad(lambda x: jnp.sum(j_qk_norm(x) * w))(x)
        xt = torch.from_numpy(x).requires_grad_(True)
        got, = torch.autograd.grad((t_qk_norm(xt) * torch.from_numpy(w)).sum(), xt)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=f"d={d}")
