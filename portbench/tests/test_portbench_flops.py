"""The yardstick's frozen counts at small shapes, against values worked by
hand."""
import pytest

from portbench import flops


@pytest.mark.parametrize("sq,skv,causal,want", [
    (4, 4, False, 16), (4, 4, True, 10),     # 1 + 2 + 3 + 4
    (2, 5, True, 9),                          # queries at positions 3 and 4: 4 + 5
    (1, 7, True, 7), (3, 3, True, 6),
])
def test_visible_pairs(sq, skv, causal, want):
    assert flops.visible_pairs(sq, skv, causal) == want


def test_flash_bound_by_operations():
    # 1 x 8192 x 8192, 32/8 heads of 128, causal: 4 D a visible pair and head
    pairs = 8192 * 8193 // 2
    ops = 4 * 128 * 32 * pairs
    assert flops.flash_bound_s(1, 8192, 8192, 32, 8, 128, True, "bfloat16") == \
        pytest.approx(ops / 989e12)


def test_flash_bound_by_exp_unit_at_heads_of_64():
    # seamless's encoder: the exp term (1.111 ms) sits just under the
    # products' (1.112 ms)
    t = flops.flash_bound_s(16, 4096, 4096, 16, 16, 64, False, "bfloat16")
    assert t == pytest.approx(4 * 64 * 16 * 16 * 4096 ** 2 / 989e12)
    exp = 16 * 16 * 4096 ** 2 / (132 * 16 * 1.83e9)
    assert exp == pytest.approx(1.1112e-3, rel=1e-3) and exp < t


def test_decode_bound_counts_valid_rows():
    # 2 rows of lengths 3 and 5, 4/2 heads of 8, bf16: q and out 2 x 2 x 4 x 8 x 2,
    # keys and values 2 x 8 rows x 2 x 8 x 2, lengths 2 x 4 bytes
    byts = 2 * 2 * 4 * 8 * 2 + 2 * 8 * 2 * 8 * 2 + 8
    assert flops.decode_bound_s([3, 5], 4, 2, 8, "bfloat16") == pytest.approx(byts / 3.35e12)


C_ENC = {"d_model": 4, "n_heads": 2, "n_kv_heads": 2, "d_head": 2, "d_ff": 8, "vocab_size": 10,
         "n_layers": 1, "n_enc_layers": 1, "enc_dec": True}
C_MOE = {"d_model": 4, "n_heads": 2, "n_kv_heads": 1, "d_head": 2, "d_ff": 6, "vocab_size": 10,
         "n_layers": 1, "moe": {"n_routed": 3, "top_k": 2, "n_shared": 1, "d_expert": 5}}


def test_encoder_prefill_flops_by_hand():
    # one layer, 1 x 3 frames: projections 2 (2 x 4 x 4 + 2 x 4 x 4) = 128 a
    # frame, GELU MLP 4 x 4 x 8 = 128 a frame, attention 4 x 2 x 2 x 9 = 144;
    # cross K/V of one decoder layer 2 x 2 x 4 x 4 = 64 a frame
    assert flops.encoder_prefill_flops(C_ENC, 1, 3) == 3 * 256 + 144 + 3 * 64


def test_lm_prefill_flops_by_hand():
    # one layer, 1 x 2 tokens, GQA 2/1 heads of 2: projections 2 (2 x 4 x 4 +
    # 2 x 4 x 2) = 96 a token; MoE router 2 x 4 x 3 = 24, two routed experts
    # 2 x 6 x 4 x 5 = 240, one shared 6 x 4 x 5 = 120; attention over 3
    # visible pairs 4 x 2 x 2 x 3 = 48; the last position's logits 2 x 4 x 10
    assert flops.lm_prefill_flops(C_MOE, 1, 2) == 2 * (96 + 24 + 240 + 120) + 48 + 80


def test_decode_flops_by_hand():
    # the encoder-decoder, rows at lengths 2 and 3 against 4 and 1 frames:
    # 2 x (128 + 128) + self 4 x 2 x 2 x 5 + cross q, o 2 x 2 x 2 x 4 x 4 +
    # cross 4 x 2 x 2 x 5, then 2 x 2 x 4 x 10 of logits
    assert flops.decode_flops(C_ENC, [2, 3], [4, 1]) == 512 + 80 + 128 + 80 + 160
