"""Training the hybrid family (Jamba) in the port against the reference, in
f32 on jamba-v0.1-52b's smoke config: one super-block of 8 sub-layers (7
Mamba, one attention at slot 4, MoE at the odd slots), a checkpoint under
block remat (``tests/torch_train_parity.py``: tolerances of
``test_torch_lm_train.py``, the reference's weights carried across).

The gradient runs through the chunked Mamba scan: the port's log2(chunk)
rounds of shifted products (``torch.cat``) against the reference's
``lax.associative_scan``, the padded ragged last chunk (S = 37 and 21 over
chunks of 16), ``A = -exp(A_log)`` and the D skip.  Products of decays are
where f32 gradients part first; at the smoke config every gradient holds
the default bound (rtol 1e-4, atol 1e-6), so none is loosened.  Three JAX
compiles.
Parameters and master weights after a step are held to ``STEP_TOL``
(the reason and the measured values are in ``torch_train_parity.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import mamba as jmb
from repro_torch.models import mamba as tmb
from repro_torch.optim import tree_leaves
from torch_train_parity import (
    GRAD_TOL, check_loss_and_grads, check_three_steps, cfgs, leaves, make_batch, port_params,
    reference_params,
)

ARCH = "jamba-v0.1-52b"


def test_loss_and_grads_match_reference():
    jcfg, tcfg = cfgs(ARCH)
    metrics = check_loss_and_grads(jcfg, tcfg, make_batch(jcfg, 2, 37, seed=1))
    assert metrics["moe_drop_frac"].item() > 0          # some slots dropped


def test_three_train_steps_match_reference():
    jcfg, tcfg = cfgs(ARCH)
    check_three_steps(jcfg, tcfg, make_batch(jcfg, 2, 21, seed=2))


def test_mamba_apply_grads_match_reference():
    """One Mamba sub-layer alone: the gradients of a weighted sum of its
    output with respect to its parameters and its input, at S = 21 and 37
    (one and two full chunks before a ragged one), both lengths in one jit."""
    jcfg, tcfg = cfgs(ARCH)
    jp = reference_params(jcfg)
    pj = jax.tree.map(lambda a: a[0], jp["blocks"]["sub0"]["mamba"])
    pt = {k: v[0].detach().clone().requires_grad_(True)
          for k, v in port_params(jp, tcfg)["blocks"]["sub0"]["mamba"].items()}
    rng = np.random.default_rng(4)
    inputs = [(rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32),
               rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)) for S in (21, 37)]

    def grads(p, all_inputs):
        return [jax.grad(lambda p, x: jnp.sum(jmb.mamba_apply(p, x, jcfg) * w),
                         argnums=(0, 1))(p, x) for x, w in all_inputs]

    ref = jax.device_get(jax.jit(grads)(pj, inputs))
    for (x, w), (gp, gx) in zip(inputs, ref):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = (tmb.mamba_apply(pt, xt, tcfg) * torch.from_numpy(w)).sum()
        got = torch.autograd.grad(out, tree_leaves(pt) + [xt])
        names = [n for n, _ in leaves(gp)]
        for name, g, r in zip(names + ["x"], got, [a for _, a in leaves(gp)] + [gx]):
            np.testing.assert_allclose(g.numpy(), r, **GRAD_TOL, err_msg=f"S={x.shape[1]} {name}")
