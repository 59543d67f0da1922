"""Training the audio family (seamless-m4t's encoder-decoder) in the port
against the reference, in f32 on seamless-m4t-large-v2's smoke config
(``tests/torch_train_parity.py``: tolerances of ``test_torch_lm_train.py``,
the reference's weights carried across; the batch adds frames).

The gradient runs through the encoder (non-causal self-attention at the
frame positions), ``enc_norm``, the decoder's causal self-attention, its
cross-attention (K/V from the encoder's output, no RoPE, no biases) and
the GELU MLPs.  In training the cross-attention is flash, non-causal, with
Sq = S tokens against Skv = Se frames (here 24 against 40), so its
backward is ``flash_attention_bwd`` at Sq != Skv; it runs at the smoke
config's heads of 16 and at seamless's published 64.  Under block remat the
decoder layers' checkpoints take the encoder's output from their closure,
and its gradient still reaches the encoder.  Three JAX compiles.
Parameters and master weights after a step are held to ``STEP_TOL``
(the reason and the measured values are in ``torch_train_parity.py``)."""
import pytest

from torch_train_parity import check_loss_and_grads, check_three_steps, cfgs, make_batch

ARCH = "seamless-m4t-large-v2"


@pytest.mark.parametrize("d_head", [16, 64])
def test_loss_and_grads_match_reference(d_head):
    jcfg, tcfg = cfgs(ARCH, d_head=d_head)
    check_loss_and_grads(jcfg, tcfg, make_batch(jcfg, 2, 24, seed=1, Se=40))


def test_three_train_steps_match_reference():
    jcfg, tcfg = cfgs(ARCH)
    check_three_steps(jcfg, tcfg, make_batch(jcfg, 2, 24, seed=2, Se=16))
