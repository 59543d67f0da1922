"""The plain reference's own invariants, and the reference against the
program at the configurations' smoke widths in f32 (within 1e-5: the
two compute the same function in another order)."""
import torch

from portbench import harness, inputs
from portbench.reference import encdec, moe_lm
from portbench.reference.common import Precision, attend_rows, attention, rope
from portbench.tests import smoke

F32 = Precision("f32")


def _qkv(seed, b=2, s=9, h=4, hkv=2, d=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, s, h, d, generator=g), torch.randn(b, s, hkv, d, generator=g),
            torch.randn(b, s, hkv, d, generator=g))


def test_causal_mask_hides_later_keys():
    q, k, v = _qkv(0)
    out = attention(q, k, v, F32, causal=True, q_block=4)
    k2, v2 = k.clone(), v.clone()
    k2[:, 5:], v2[:, 5:] = 100.0, -100.0
    out2 = attention(q, k2, v2, F32, causal=True, q_block=4)
    assert torch.equal(out[:, :5], out2[:, :5]) and not torch.allclose(out[:, 5:], out2[:, 5:])
    # the first query sees only the first key: its output is that value
    assert torch.allclose(out[:, 0], v[:, 0].repeat_interleave(2, dim=1), atol=1e-6)


def test_attend_rows_is_attention_at_each_length():
    q, k, v = _qkv(1)
    lengths = torch.tensor([3, 9])
    got = attend_rows(q[:, 0], k, v, lengths, F32)
    for b, n in enumerate(lengths.tolist()):
        want = attention(q[b:b + 1, :1], k[b:b + 1, :n], v[b:b + 1, :n], F32, causal=False)
        assert torch.allclose(got[b], want[0, 0], atol=1e-6)


def test_rope_keeps_norms_and_relative_positions():
    q, k, _ = _qkv(2, hkv=4)
    pos = torch.arange(9)[None, :]
    qr, kr = rope(q, pos, 10_000.0), rope(k, pos, 10_000.0)
    assert torch.allclose(qr.norm(dim=-1), q.norm(dim=-1), atol=1e-5)
    # q at i and k at j meet as they would at i + 3, j + 3
    s0 = torch.einsum("bqhd,bkhd->bhqk", qr, kr)
    s3 = torch.einsum("bqhd,bkhd->bhqk", rope(q, pos + 3, 10_000.0), rope(k, pos + 3, 10_000.0))
    assert torch.allclose(s0, s3, atol=1e-4)


def test_capacity_keeps_the_earliest_pairs():
    ids = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 1]])
    # expert 0's pairs in flat order: (0,0), (1,0), (2,1), (3,0): capacity 2 keeps two
    assert moe_lm.kept(ids, 3, 2).tolist() == [[True, True], [True, True],
                                                [True, False], [False, False]]
    assert moe_lm.capacity({"moe": {"top_k": 4, "n_routed": 60, "capacity_factor": 1.25}},
                           8192) == 683


def test_moe_drops_change_only_dropped_tokens():
    c = smoke.spec("qwen2-moe.prefill-decode")["config"]
    w = inputs.make_weights(_template(c), 5, "cpu")
    p = {k: v[0] for k, v in w["layers"]["moe"].items() if k != "shared"}
    p["shared"] = {k: v[0] for k, v in w["layers"]["moe"]["shared"].items()}
    h = torch.randn(12, c["d_model"], generator=torch.Generator().manual_seed(3))
    full, capped = moe_lm.moe(p, h, c, F32, None), moe_lm.moe(p, h, c, F32, 2)
    _, ids = moe_lm.route(h, p["router"], c["moe"]["top_k"], F32)
    whole = moe_lm.kept(ids, c["moe"]["n_routed"], 2).all(-1)
    assert torch.allclose(full[whole], capped[whole], atol=1e-6)
    assert not torch.allclose(full[~whole], capped[~whole])


def _template(c):
    from repro_torch.models.model import init_params

    return init_params(harness.model_config(c), device="meta")


def test_encdec_reference_is_the_program_at_smoke_widths():
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step

    c = smoke.spec("seamless.encode-decode")["config"]
    cfg = harness.model_config(c)
    w = inputs.make_weights(_template(c), 11, "cpu")
    fr = inputs.frames(11, 0, 2, c["enc_len"], c["d_model"], "cpu").float()
    lens = torch.tensor([c["enc_len"], 5], dtype=torch.int32)
    cache = make_prefill_step(cfg, ShapeConfig("t", 8, 2, "prefill"), "cpu")(w, fr, lens)
    enc = encdec.encoder(w, fr, c, F32)
    for i, k, v in encdec.cross_kv(w, enc, c, F32):
        assert torch.allclose(cache["cross"]["k"][i], k, atol=1e-5)
        assert torch.allclose(cache["cross"]["v"][i], v, atol=1e-5)
    first = [(i, cache["self"]["k"][i].clone(), cache["self"]["v"][i].clone())
             for i in range(c["n_layers"])]
    ref = encdec.Decoder(w, c, F32, first, encdec.cross_kv(w, enc, c, F32), lens, 8)
    step = make_decode_step(cfg, 2, 8, "cpu")
    tok, pos = torch.tensor([3, 200]), torch.tensor([0, 2], dtype=torch.int32)
    for _ in range(3):
        got, _ = step(w, cache, tok, pos)
        assert torch.allclose(got, ref.step(tok, pos), atol=1e-5)
        tok, pos = got.argmax(-1), pos + 1


def test_moe_lm_reference_is_the_program_at_smoke_widths():
    from repro_torch.models.model import decode_step, prefill

    c = smoke.spec("qwen2-moe.prefill-decode")["config"]
    cfg = harness.model_config(c)
    w = inputs.make_weights(_template(c), 12, "cpu")
    toks = inputs.tokens(12, 0, (3, 10), c["vocab_size"], "cpu")
    last, cache = prefill(w, toks, cfg, 10)
    first = []
    for i, k, v in moe_lm.prefill(w, toks, c, F32):
        if i == "logits":
            assert torch.allclose(last, k, atol=1e-5)
            continue
        assert torch.allclose(cache["k"][i], k, atol=1e-5)
        first.append((i, torch.cat([k, torch.zeros_like(k)], 1), torch.cat([v, v * 0], 1)))
    big = {n: torch.cat([cache[n], torch.zeros_like(cache[n])], 2) for n in ("k", "v")}
    ref = moe_lm.Decoder(w, c, F32, first, 20)
    tok, pos = last.argmax(-1), torch.full((3,), 10, dtype=torch.int32)
    for _ in range(3):
        got, _ = decode_step(w, big, tok, pos, cfg)
        assert torch.allclose(got, ref.step(tok, pos), atol=1e-5)
        tok, pos = got.argmax(-1), pos + 1
