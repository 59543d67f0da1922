"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, the dense model, the MoE dispatch and the Mamba scan on the card
against the same code on the CPU,
the stream executor on the card, the vectorized environment (its perfmodel
replayed from a CUDA graph) against the CPU, and a short training run.

They skip without an sm_90 card.  On a machine with one (and without JAX,
which ``tests/conftest.py`` imports), run them as

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
from repro_torch.models import model as tm
from repro_torch.runtime.multitenant import FusedCoRunner, Tenant

pytestmark = pytest.mark.cuda

# largest ||out - ref|| / ||ref|| over the output rows (one query head of
# one token); it scales with the row, so a row that lost part of its keys
# fails even where its entries are small.  A row whose reference is 0 must
# be exactly 0.  chip_smoke.py holds the kernels to the same bound.
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _assert_rows_close(out, ref, dtype):
    diff = (out.float() - ref.float()).flatten(0, -2).norm(dim=-1)
    size = ref.float().flatten(0, -2).norm(dim=-1)
    rel = torch.where(diff == 0, torch.zeros_like(diff), diff / size).max().item()
    assert rel <= ROW_TOL[dtype], f"row relative error {rel:.3e} above {ROW_TOL[dtype]:g}"


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


def _decode_inputs(rng, lengths, smax, hkv, group, dtype, device, D=128):
    B = len(lengths)
    q = _randn(rng, (B, hkv * group, D), dtype, device)
    k = _randn(rng, (B, smax, hkv, D), dtype, device)
    v = _randn(rng, (B, smax, hkv, D), dtype, device)
    for b, n in enumerate(lengths):
        k[b, n:] = 3e4          # never read: must not reach the output
        v[b, n:] = -3e4
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=device)


def _check_decode(q, k, v, lens):
    before = decode_attention.launches
    out = decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    for b, n in enumerate(lens.tolist()):
        if n == 0:
            assert torch.all(out[b] == 0), "a row of length 0 gives 0"
    _assert_rows_close(out, decode_attention_plain(q, k, v, lens), q.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [1, 4, 5, 8])
def test_decode_kernel_matches_plain(card, dtype, group):
    rng = np.random.default_rng(group)
    _check_decode(*_decode_inputs(rng, [1000, 333, 1, 0, 64], 1000, 2, group, dtype, card))


# heads of 64 (seamless-m4t: 16/16 heads, its self and cross decode), at
# tile edges and a row of length 0
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [1, 4])
def test_decode_kernel_at_d64(card, dtype, group):
    rng = np.random.default_rng(400 + group)
    _check_decode(*_decode_inputs(rng, [1000, 31, 32, 33, 0, 1, 4096], 4096, 4, group, dtype,
                                  card, D=64))


# the bf16 kernel's 32-key tiles: one key below, at and above a tile; a
# length past Smax; Smax not a tile multiple; rows of length 0 among them
@pytest.mark.parametrize("group", [1, 4, 8])
def test_decode_kernel_tile_edges(card, group):
    rng = np.random.default_rng(100 + group)
    q, k, v, lens = _decode_inputs(rng, [31, 32, 33, 0, 1, 1005, 63, 65], 1000, 2, group,
                                   torch.bfloat16, card)
    _check_decode(q, k, v, lens)


# one pair spread over every block of the grid: its tiles one below, at and
# one above the grid's size (a block share of one tile, and then of two),
# and a length one key below, at and above a share
@pytest.mark.parametrize("extra", [-33, -32, -1, 0, 1, 32, 33])
def test_decode_kernel_one_long_pair(card, extra):
    from repro_torch.kernels.decode_attention.ops import _TILE, grid_blocks

    tile = _TILE[torch.bfloat16]
    smax = 700 * tile + 5
    n_blocks = grid_blocks(card, 1, smax, 128)
    rng = np.random.default_rng(200 + extra)
    q, k, v, lens = _decode_inputs(rng, [n_blocks * tile + extra], smax, 1, 8, torch.bfloat16,
                                   card)
    _check_decode(q, k, v, lens)


def test_decode_kernel_in_a_cuda_graph(card):
    """One call captured in a CUDA graph and replayed after the lengths are
    changed in place gives what the eager call gives at the new lengths:
    the wrapper reads nothing back and sizes nothing from the lengths."""
    rng = np.random.default_rng(300)
    q, k, v, lens = _decode_inputs(rng, [4000, 17, 2500], 4096, 8, 4, torch.bfloat16, card)
    k[:], v[:] = _randn(rng, k.shape, k.dtype, card), _randn(rng, v.shape, v.dtype, card)
    decode_attention(q, k, v, lens)      # build and warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, lens)
    for new in ([4000, 17, 2500], [1, 4096, 0], [2048, 33, 4095]):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        eager = decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, eager, atol=0, rtol=0)
        _assert_rows_close(out, decode_attention_plain(q, k, v, lens), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,Skv,causal", [(200, 200, True), (77, 333, True),
                                           (333, 77, True), (130, 250, False)])
def test_flash_kernel_matches_plain(card, dtype, Sq, Skv, causal):
    rng = np.random.default_rng(Sq * 7 + Skv)
    B, Hq, Hkv, D = 2, 4, 2, 128
    q = _randn(rng, (B, Sq, Hq, D), dtype, card)
    k = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    v = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v, causal=causal)
    _assert_rows_close(out, ref, dtype)


# the zoo's head groups: 1 (deepseek-moe, qwen2-moe: 16/16), 5 (qwen2.5-14b:
# 40/8) and 8 (chameleon: 64/8)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Hq,Hkv", [(16, 16), (40, 8), (64, 8)])
def test_flash_kernel_head_groups(card, dtype, Hq, Hkv):
    rng = np.random.default_rng(Hq)
    B, Sq, Skv, D = 1, 300, 300, 128
    q = _randn(rng, (B, Sq, Hq, D), dtype, card)
    k = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    v = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_rows_close(out, flash_attention_plain(q, k, v, causal=True), dtype)


# the bf16 kernel's tiles are 128 q rows by 128 kv rows: one row short of a
# tile, a whole tile, one row into the next, and a ragged 1000; Sq > Skv
# leaves the first Sq - Skv rows of a causal run with no visible key
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Skv", [127, 128, 129, 1000])
@pytest.mark.parametrize("Sq", [127, 128, 129, 1000])
def test_flash_kernel_tile_edges(card, Sq, Skv, causal):
    rng = np.random.default_rng(Sq * 11 + Skv * 3 + causal)
    B, Hq, Hkv, D = 2, 8, 2, 128
    q = _randn(rng, (B, Sq, Hq, D), torch.bfloat16, card)
    k = _randn(rng, (B, Skv, Hkv, D), torch.bfloat16, card)
    v = _randn(rng, (B, Skv, Hkv, D), torch.bfloat16, card)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    if causal and Sq > Skv:
        assert torch.all(out[:, :Sq - Skv] == 0), "rows with no visible key give 0"
    _assert_rows_close(out, flash_attention_plain(q, k, v, causal=causal), torch.bfloat16)


# heads of 64: the encoder (non-causal, Sq == Skv), cross-attention in
# teacher forcing (Sq != Skv) and the decoder's causal self-attention, at
# the 128-row tile edges
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,Skv,causal", [(300, 300, False), (129, 1000, False),
                                           (127, 127, True), (1000, 129, True)])
def test_flash_kernel_at_d64(card, dtype, Sq, Skv, causal):
    rng = np.random.default_rng(Sq * 5 + Skv + causal)
    B, Hq, Hkv, D = 2, 4, 4, 64
    q = _randn(rng, (B, Sq, Hq, D), dtype, card)
    k = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    v = _randn(rng, (B, Skv, Hkv, D), dtype, card)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _assert_rows_close(out, flash_attention_plain(q, k, v, causal=causal), dtype)


def _check_flash(q, k, v, causal):
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    Sq, Skv = q.shape[1], k.shape[1]
    if causal and Sq > Skv:
        assert torch.all(out[:, :Sq - Skv] == 0), "rows with no visible key give 0"
    _assert_rows_close(out, flash_attention_plain(q, k, v, causal=causal), q.dtype)


# the bf16 kernel at heads of 64: its kv tiles of 128 rows and its q tiles
# of 128 rows (two consumer warpgroups, on a small grid) or 192 (three, on a
# grid of at least two blocks an SM: 288 heads of 4 x 72 here), one row
# short of a tile and one row over on both axes, Sq != Skv, causal and not
# (Sq > Skv: causal rows with no visible key give exactly 0)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Skv", [(127, 129), (129, 127), (191, 193), (193, 191), (255, 257),
                                    (385, 383), (128, 1000), (1000, 383)])
@pytest.mark.parametrize("B,Hq,Hkv", [(2, 4, 2), (4, 72, 8)])
def test_flash_kernel_d64_tile_edges(card, B, Hq, Hkv, Sq, Skv, causal):
    rng = np.random.default_rng(Sq * 13 + Skv * 5 + Hq + causal)
    D = 64
    q = _randn(rng, (B, Sq, Hq, D), torch.bfloat16, card)
    k = _randn(rng, (B, Skv, Hkv, D), torch.bfloat16, card)
    v = _randn(rng, (B, Skv, Hkv, D), torch.bfloat16, card)
    _check_flash(q, k, v, causal)


# a head group of 8 at heads of 64 (16 q heads on 2 kv heads)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_d64_head_group_of_8(card, causal):
    rng = np.random.default_rng(808 + causal)
    B, Sq, Skv, Hq, Hkv, D = 2, 300, 700, 16, 2, 64
    q = _randn(rng, (B, Sq, Hq, D), torch.bfloat16, card)
    k = _randn(rng, (B, Skv, Hkv, D), torch.bfloat16, card)
    v = _randn(rng, (B, Skv, Hkv, D), torch.bfloat16, card)
    _check_flash(q, k, v, causal)


# scores that grow along the keys: every q row leans on one direction that
# later keys take more of, so a row's max moves in every kv tile, the last
# included (O and the row sum are rescaled only where the max moved)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,B,Hq,Hkv", [(64, 2, 4, 2), (64, 4, 72, 8), (128, 2, 4, 2)])
def test_flash_kernel_rising_max(card, D, B, Hq, Hkv, causal):
    rng = np.random.default_rng(900 + D + Hq + causal)
    Sq, Skv = 600, 1000
    q = np.abs(rng.standard_normal((B, Sq, Hq, D)))
    ramp = np.linspace(0.0, 3.0, Skv)[None, :, None, None]
    k = 0.5 * rng.standard_normal((B, Skv, Hkv, D)) + ramp
    v = rng.standard_normal((B, Skv, Hkv, D))
    q, k, v = (torch.from_numpy(x.astype(np.float32)).to(card, torch.bfloat16) for x in (q, k, v))
    _check_flash(q, k, v, causal)


# scores near bf16's large end: q and k scaled by 30, scores in the
# thousands (a scale folded in the wrong place overflows the exponential)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_large_scores(card, D, causal):
    rng = np.random.default_rng(1000 + D + causal)
    B, Sq, Skv, Hq, Hkv = 2, 333, 555, 4, 2
    q = _randn(rng, (B, Sq, Hq, D), torch.float32, card) * 30
    k = _randn(rng, (B, Skv, Hkv, D), torch.float32, card) * 30
    v = _randn(rng, (B, Skv, Hkv, D), torch.bfloat16, card)
    _check_flash(q.bfloat16(), k.bfloat16(), v, causal)


def test_flash_kernel_refuses_unaligned_tensors(card):
    """TMA reads from a 16-byte boundary: a view one element in is refused."""
    q = torch.zeros((2, 128, 8, 128), dtype=torch.bfloat16, device=card)
    kv = torch.zeros((2, 128, 2, 128), dtype=torch.bfloat16, device=card)
    buf = torch.zeros(1 + q.numel(), dtype=torch.bfloat16, device=card)
    q_off = buf[1:].view(q.shape)
    k_off = buf[1:1 + kv.numel()].view(kv.shape)
    assert q_off.is_contiguous() and q_off.data_ptr() % 16 != 0
    before = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q_off, kv, kv)
    with pytest.raises(ValueError):
        flash_attention(q, k_off, kv)
    assert flash_attention.launches == before


def test_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros((1, 4, 96), device=card)        # D = 96: the kernels take 64 and 128
    kv = torch.zeros((1, 8, 2, 96), device=card)
    with pytest.raises(ValueError):
        decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32, device=card))
    with pytest.raises(ValueError):
        flash_attention(q[:, None], kv, kv)
    # the decode kernel's bulk copies read from 16-byte boundaries
    buf = torch.zeros(1 + 4 * 128, dtype=torch.bfloat16, device=card)
    q_off = buf[1:].view(1, 4, 128)
    kv = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):
        decode_attention(q_off, kv, kv, torch.ones(1, dtype=torch.int32, device=card))


def _small_cfg():
    # smoke widths, but heads of 128, the only D the kernels take
    return get_smoke_config("llama3-8b").replace(d_head=128, dtype="float32")


def test_model_on_card_matches_cpu(card):
    cfg = _small_cfg()
    cpu = tm.init_params(cfg, seed=3, device="cpu")
    gpu = _to(cpu, card)
    rng = np.random.default_rng(0)
    B, S = 2, 40
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    lc, cc = tm.prefill(cpu, tokens, cfg, S)
    lg, cg = tm.prefill(gpu, tokens.to(card), cfg, S)
    torch.testing.assert_close(lg.cpu(), lc, atol=2e-3, rtol=2e-2)
    torch.testing.assert_close(cg["k"].cpu(), cc["k"], atol=2e-3, rtol=2e-2)
    cache_c, cache_g = tm.init_cache(cpu, cfg, B, 8), tm.init_cache(gpu, cfg, B, 8)
    for t in range(8):
        pos = torch.full((B,), t, dtype=torch.int32)
        l1, _ = tm.decode_step(cpu, cache_c, tokens[:, t], pos, cfg)
        l2, _ = tm.decode_step(gpu, cache_g, tokens[:, t].to(card), pos.to(card), cfg)
        torch.testing.assert_close(l2.cpu(), l1, atol=2e-3, rtol=2e-2)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def test_encdec_on_card_matches_cpu(card):
    """The audio family at seamless-m4t's head size of 64 (smoke widths, f32):
    the loss, the prefill step's cross K/V and 6 decode steps at ragged
    enc_lens on the card against the CPU."""
    from repro_torch.configs import SHAPES, scaled_shape
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step

    cfg = get_smoke_config("seamless-m4t-large-v2").replace(d_head=64, dtype="float32")
    cpu = tm.init_params(cfg, seed=5, device="cpu")
    gpu = _to(cpu, card)
    rng = np.random.default_rng(6)
    B, S, Se = 2, 12, 40
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    frames = torch.from_numpy(rng.standard_normal((B, Se, cfg.d_model)).astype(np.float32))
    labels = torch.roll(tokens, -1, 1)
    with torch.no_grad():
        lc, _ = tm.loss_fn(cpu, {"tokens": tokens, "labels": labels, "frames": frames}, cfg)
        lg, _ = tm.loss_fn(gpu, {"tokens": tokens.to(card), "labels": labels.to(card),
                                 "frames": frames.to(card)}, cfg)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-5, rtol=1e-5)
    shape = scaled_shape(SHAPES["decode_32k"], 64, 32768 // S)        # B x S self slots
    enc_lens = torch.tensor([Se, 23], dtype=torch.int32)
    cc = make_prefill_step(cfg, shape, device="cpu")(cpu, frames, enc_lens)
    cg = make_prefill_step(cfg, shape, device=card)(gpu, frames.to(card), enc_lens.to(card))
    for key in ("k", "v"):
        torch.testing.assert_close(cg["cross"][key].cpu(), cc["cross"][key], atol=1e-5,
                                   rtol=1e-5)
    dc, dg = make_decode_step(cfg, B, S, device="cpu"), make_decode_step(cfg, B, S, device=card)
    for t in range(6):
        pos = torch.full((B,), t, dtype=torch.int32)
        l1, cc = dc(cpu, cc, tokens[:, t], pos)
        l2, cg = dg(gpu, cg, tokens[:, t].to(card), pos.to(card))
        _assert_rows_close(l2.cpu(), l1, torch.float32)


def _first_layer(tree):
    return {k: _first_layer(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


@pytest.mark.parametrize("cap", [0.5, 1.25])
def test_moe_on_card_matches_cpu(card, cap):
    """The dispatch drops the same slots on the card (argsort, bincount and
    the spare-row scatter); outputs within the f32 row bound."""
    import dataclasses

    from repro_torch.models import moe as tmoe

    cfg = get_smoke_config("deepseek-moe-16b").replace(dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    cpu = _first_layer(tm.init_params(cfg, seed=4, device="cpu")["layers"]["moe"])
    gpu = _to(cpu, card)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 64, 64)).astype(np.float32))
    yc, auxc = tmoe.moe_apply(cpu, x, cfg)
    yg, auxg = tmoe.moe_apply(gpu, x.to(card), cfg)
    assert auxg["moe_drop_frac"].item() == auxc["moe_drop_frac"].item()
    assert (auxc["moe_drop_frac"].item() > 0) == (cap < 1)
    _assert_rows_close(yg.cpu(), yc, torch.float32)
    _assert_rows_close(tmoe.moe_decode(gpu, x[0].to(card), cfg).cpu(),
                       tmoe.moe_decode(cpu, x[0], cfg), torch.float32)


def test_mamba_on_card_matches_cpu(card):
    """The chunked scan (3 chunks of 16, the last one ragged) and the
    decode recurrence."""
    from repro_torch.models import mamba as tmb

    cfg = get_smoke_config("jamba-v0.1-52b").replace(dtype="float32")
    cpu = _first_layer(tm.init_params(cfg, seed=6, device="cpu")["blocks"]["sub0"]["mamba"])
    gpu = _to(cpu, card)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 37, 64)).astype(np.float32))
    _assert_rows_close(tmb.mamba_apply(gpu, x.to(card), cfg).cpu(),
                       tmb.mamba_apply(cpu, x, cfg), torch.float32)
    sc = tmb.init_mamba_state(cfg, 2, device="cpu")
    sg = tmb.init_mamba_state(cfg, 2, device=card)
    for t in range(4):
        yc, sc = tmb.mamba_decode(cpu, x[:, t], sc, cfg)
        yg, sg = tmb.mamba_decode(gpu, x[:, t].to(card), sg, cfg)
        _assert_rows_close(yg.cpu(), yc, torch.float32)


def test_fused_corunner_streams_match_sequential(card):
    """Two tenants on their own streams give what each gives alone."""
    def make(name, seed, stream):
        with torch.cuda.stream(stream):
            x = torch.randn((512, 512), generator=torch.Generator(card).manual_seed(seed),
                            device=card)
        return Tenant(name, lambda s: torch.tanh(s @ s.T / 512.0), x, 0.5, stream=stream)

    solo = []
    for name, seed in (("a", 1), ("b", 2)):
        t = make(name, seed, None)
        st = t.state
        for _ in range(6):
            st = t.step_fn(st)
        solo.append(st)
    tenants = [make("a", 1, torch.cuda.Stream()), make("b", 2, torch.cuda.Stream())]
    finish = FusedCoRunner(tenants, {"a": 6, "b": 6}, quanta_per_cycle=2).run()
    assert set(finish) == {"a", "b"}
    for t, ref in zip(tenants, solo):
        torch.testing.assert_close(t.state, ref)


# (8192, 4096): the llama3-8b prefill tenant's residual stream; the others
# ragged: rows not a multiple of the block, d not a multiple of 8
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d", [(8192, 4096), (1000, 4100), (1000, 4101), (7, 3), (33, 130),
                                    (17, 8)])
def test_rmsnorm_kernel_matches_plain(card, dtype, rows, d):
    rng = np.random.default_rng(rows + d)
    x = _randn(rng, (rows, d), dtype, card) * 3
    scale = _randn(rng, (d,), dtype, card)
    before = rmsnorm.launches
    out = rmsnorm(x, scale, eps=1e-5)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    _assert_rows_close(out, rmsnorm_plain(x, scale, eps=1e-5), dtype)


# the register path holds rows of up to 2048 16-byte vectors (16384 bf16,
# 8192 f32); one element past it takes the two-pass path.  1 and 7 rows
# widen to 256 threads a row, 1000 rows of 8192 f32 as well
@pytest.mark.parametrize("rows", [1, 7, 1000])
@pytest.mark.parametrize("past_cap", [-1, 0, 1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_kernel_at_the_register_cap(card, dtype, past_cap, rows):
    d = 2048 * (16 // torch.tensor([], dtype=dtype).element_size()) + past_cap
    rng = np.random.default_rng(rows + past_cap)
    x = _randn(rng, (rows, d), dtype, card) * 3
    scale = _randn(rng, (d,), dtype, card)
    before = rmsnorm.launches
    out = rmsnorm(x, scale, eps=1e-5)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    _assert_rows_close(out, rmsnorm_plain(x, scale, eps=1e-5), dtype)


def test_rmsnorm_kernel_unaligned_rows_and_mixed_scale(card):
    """x starting off a 16-byte boundary takes the scalar path; an f32
    scale beside bf16 or f16 activations; a 3-d input."""
    rng = np.random.default_rng(0)
    for dtype in (torch.bfloat16, torch.float16):
        buf = _randn(rng, (1 + 37 * 200,), dtype, card)
        x = buf[1:].view(37, 200)
        assert x.data_ptr() % 16 != 0
        scale = _randn(rng, (200,), torch.float32, card)
        _assert_rows_close(rmsnorm(x, scale), rmsnorm_plain(x, scale), torch.bfloat16)
    x = _randn(rng, (2, 5, 100), torch.float32, card)
    scale = _randn(rng, (100,), torch.float32, card)
    _assert_rows_close(rmsnorm(x, scale), rmsnorm_plain(x, scale), torch.float32)


def test_rmsnorm_refuses_what_it_does_not_take(card):
    x = torch.zeros((4, 64), device=card)
    for bad in (torch.zeros(63, device=card), torch.zeros(64),
                torch.zeros(64, device=card, dtype=torch.float64)):
        with pytest.raises(ValueError):
            rmsnorm(x, bad)
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros((64, 4), device=card).T, torch.zeros(64, device=card))
    with pytest.raises(ValueError):
        rmsnorm(x.double(), torch.zeros(64, device=card, dtype=torch.float64))


def test_vec_env_on_card_matches_cpu(card):
    """The batched environment, its perfmodel replayed from a CUDA graph,
    gives the CPU's observations, masks and dones, and its rewards within
    f32 rounding, on the same action stream: ``chip_smoke.py``'s check."""
    from repro_torch.core import EnvConfig, make_zoo

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    chip_smoke.check_env_on_card(torch, make_zoo(dryrun_dir=None), EnvConfig(window=8, c_max=4))


# the uniform ring; and the prioritized ring with sampled contexts and the
# telemetry records
@pytest.mark.parametrize("extra", [{}, {"per_alpha": 0.6, "obs_context": True,
                                        "telemetry": True}])
def test_short_training_run_on_card(card, extra):
    from repro_torch.core import EnvConfig, RLScheduler, make_zoo, paper_queues
    from repro_torch.core.agent import DQNAgent, DQNConfig
    from repro_torch.core.train import TrainConfig, train_agent

    zoo = make_zoo(dryrun_dir=None)
    env_cfg = EnvConfig(window=4, c_max=3)
    agent, hist = train_agent(zoo, env_cfg, TrainConfig(
        episodes=60, eval_every=30, n_train_queues=4, batch_envs=8, update_every=8,
        dqn=DQNConfig(buffer_size=512, batch_size=32, eps_decay_steps=400), **extra),
        device=card)
    assert agent.updates > 0 and all(np.isfinite(h["eval_throughput"]) for h in hist)
    if extra:
        assert hist[-1]["loss"] is not None and np.isfinite(hist[-1]["loss"])
        env_cfg = EnvConfig(window=4, c_max=3, obs_context=True)
    cpu = DQNAgent(agent.params["w0"].shape[0], agent.params["wA"].shape[1], device="cpu",
                   params={k: v.cpu() for k, v in agent.params.items()})
    for queue in paper_queues(zoo, window=4, per_kind=1).values():
        a = RLScheduler(agent, env_cfg).schedule(queue)
        b = RLScheduler(cpu, env_cfg).schedule(queue)
        assert [p.label for p in a.partitions] == [p.label for p in b.partitions]
        assert [[j.name for j in g] for g in a.groups] == [[j.name for j in g] for g in b.groups]


# the backward: the autograd Function on the card (forward: the kernel)
# against flash_attention_bwd on the CPU, fed the card's forward output so
# that only the backward is compared; ragged Sq, Sq < Skv and Sq > Skv
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,Skv,causal", [(200, 200, True), (77, 333, True),
                                           (333, 77, True), (129, 250, False)])
def test_flash_backward_on_card_matches_cpu(card, dtype, Sq, Skv, causal):
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd

    rng = np.random.default_rng(Sq * 5 + Skv)
    B, Hq, Hkv, D = 2, 8, 2, 128
    q, k, v = (_randn(rng, s, dtype, card).requires_grad_(True)
               for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    dout = _randn(rng, (B, Sq, Hq, D), dtype, card)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_bwd(*(t.detach().cpu() for t in (q, k, v, out, dout)), causal, None)
    for g, r in zip(grads, ref):
        assert g.dtype == r.dtype == dtype and torch.isfinite(g).all()
    # a row that sees one key has P = 1 and dq = 0 but for the rounding of
    # dP - Delta (two sums of the same products in another order), so its
    # dq is held to the row tolerance of the median norm of the rows that see
    # more keys; the rest of dq, and dk and dv, row by row
    seen = (torch.arange(Sq) + Skv - Sq + 1).clamp(0, Skv) if causal else torch.full((Sq,), Skv)
    one = seen == 1
    dq, ref_dq = grads[0].cpu(), ref[0]
    typical = ref_dq[:, seen > 1].float().flatten(0, -2).norm(dim=-1).median()
    assert (dq[:, one].float().flatten(0, -2).norm(dim=-1) <= ROW_TOL[dtype] * typical).all()
    _assert_rows_close(dq[:, ~one], ref_dq[:, ~one], dtype)
    for g, r in zip(grads[1:], ref[1:]):
        _assert_rows_close(g.cpu(), r, dtype)
    if causal and Sq > Skv:
        assert torch.all(dq[:, :Sq - Skv] == 0), "rows with no visible key: zero dq"


def test_train_step_on_card_matches_cpu(card):
    """Two train steps of a small f32 model on the card and on the CPU:
    the losses within 1e-5 relative, the parameters within 2e-5 (as
    ``chip_smoke.py`` phase 5 bounds them), and the flash kernel launched
    twice a layer a step (forward and block-remat recompute)."""
    from repro_torch.data import DataPipeline, batch_to_device
    from repro_torch.optim import OptConfig, init_opt_state, tree_leaves
    from repro_torch.runtime.lm_train import train_step

    cfg = _small_cfg()
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=5, decay_steps=1000)
    batch = DataPipeline(cfg.vocab_size, 200, 2, seed=4).batch(0)
    out = {}
    for device in ("cpu", card):
        params = _to(tm.init_params(cfg, seed=5, device="cpu"), device)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        opt, b = init_opt_state(params), batch_to_device(batch, device)
        before = flash_attention.launches
        losses = []
        for _ in range(2):
            params, opt, m = train_step(params, opt, b, cfg, opt_cfg)
            losses.append(m["loss"].item())
        launched = flash_attention.launches - before
        out[str(device)] = (losses, [p.detach().cpu() for p in tree_leaves(params)], launched)
    (lc, pc, nc), (lg, pg, ng) = out["cpu"], out[str(card)]
    assert nc == 0 and ng == 2 * 2 * cfg.n_layers
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for a, b in zip(pg, pc):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)


def test_vecsim_masked_scatter_and_first_index_ties_on_card(card):
    """The vectorized simulator's primitives on the card: a masked-off write
    lands in the dropped spare row (no device-side assert, no real row
    touched), and argmin / first-fit take the first index on ties, as
    ``jnp.argmin`` / ``jnp.argmax`` do."""
    from repro_torch.online import vecsim as tv

    x = torch.arange(12, device=card).reshape(2, 6)
    out = tv._put(x, torch.tensor([6, 2], device=card), torch.tensor([-1, -7], device=card))
    assert out.tolist() == [[0, 1, 2, 3, 4, 5], [6, 7, -7, 9, 10, 11]]
    acc = tv._add(torch.zeros(2, 4, device=card), torch.tensor([[4, 1, 1], [0, 4, 4]], device=card),
                  torch.ones(2, 3, device=card))
    assert acc.tolist() == [[0, 2, 0, 0], [1, 0, 0, 0]]
    busy = torch.tensor([[True, True, False, False, True, False, False, False],
                         [True] * 8], device=card)
    assert torch.argmin(busy.to(torch.int32), dim=1).tolist() == [2, 0]
    free = ~busy
    assert tv._first_true(free).tolist() == [2, 0]
    ftab = tv._fit_table(free)                       # (2, U, 8): width 1, 2, 4, 8
    assert tv._first_true(ftab[0]).tolist() == [2, 2, 0, 0]
    seqs = torch.tensor([[5, 3, 3, 9], [7, 7, 7, 7]], device=card)
    active = torch.tensor([[True, True, True, False], [True] * 4], device=card)
    st = tv._State(*([None] * len(tv._State._fields)))._replace(r_active=active, r_seq=seqs)
    head, exists = tv._head(st)
    assert head.tolist() == [1, 0] and exists.tolist() == [True, True]


def test_vecsim_sweep_on_card_matches_cpu(card):
    """One sweep of 8 poisson traces on the card equals the same sweep on
    the CPU: time sharing lane for lane, and the golden agent's RL engine
    (its forward in f32 without TF32) decision for decision."""
    from repro_torch.convert import GOLDEN_WINDOW, load_golden_dqn
    from repro_torch.core import EnvConfig, make_zoo
    from repro_torch.online import RLDispatchPolicy, TimeSharingPolicy, poisson_trace
    from repro_torch.online.vecsim import VectorizedClusterSimulator

    zoo = make_zoo(dryrun_dir=None)
    traces = [poisson_trace(zoo, n=40, load=1.25, seed=s) for s in range(8)]
    golden = Path(__file__).parent / "golden" / "train_agent_proxy_v1.npz"
    for make in (lambda dev: TimeSharingPolicy(),
                 lambda dev: RLDispatchPolicy(load_golden_dqn(golden, dev),
                                              EnvConfig(window=GOLDEN_WINDOW))):
        out = {}
        for dev in ("cuda", "cpu"):
            eng = VectorizedClusterSimulator(make(dev), window=GOLDEN_WINDOW, capacity=64,
                                             device=dev)
            out[dev] = (eng.sweep(traces), eng.run(traces[3]))
        (sc, rc), (sp, rp) = out["cuda"], out["cpu"]
        for name, a, b in zip(sc._fields, sc, sp):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-3, msg=name)
        for name in ("dispatches", "backfills", "err"):
            assert torch.equal(getattr(sc, name).cpu(), getattr(sp, name)), name
        assert [(r.group_size, r.partition, r.units, r.backfilled) for r in rc.jobs] == \
            [(r.group_size, r.partition, r.units, r.backfilled) for r in rp.jobs]
        assert [s.slices for s in rc.timeline] == [s.slices for s in rp.timeline]


def test_sharded_steps_on_a_1x1_mesh_equal_the_one_device_steps(card):
    """``chip_smoke.py`` phase 11 (b) at a smoke size: prefill, two decode
    steps and a train step through DTensors on a 1 x 1 mesh (a world of one
    NCCL rank) equal the ``mesh=None`` steps bit for bit, and launch the
    flash and decode kernels inside ``local_map``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import launcher_mesh
    from repro_torch.optim import OptConfig, init_opt_state, tree_leaves, tree_map
    from repro_torch.runtime.steps import (
        full, make_decode_step, make_prefill_step, make_train_step,
    )

    cfg = _small_cfg()
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=g, dtype=torch.int32).to(card)
    batch = {"tokens": tokens, "labels": tokens}
    shape = ShapeConfig("t", 24, 2, "prefill")
    pos = torch.tensor([3, 17], dtype=torch.int32, device=card)
    params = tm.init_params(cfg, seed=5, device=card)

    def run(mesh):
        p = tree_map(torch.clone, params)
        pf = make_prefill_step(cfg, shape, card, mesh=mesh)
        dec = make_decode_step(cfg, 2, 24, card, mesh=mesh)
        tr = make_train_step(cfg, OptConfig(), card, mesh=mesh)
        if mesh is None:
            opt = init_opt_state(p)
        else:
            p, opt = tr.distribute(p)
        flash, decode = flash_attention.launches, decode_attention.launches
        logits, _ = pf(p, tokens)
        cache = dec.init_cache(p)
        outs = [full(logits)]
        for i in range(2):
            lg, cache = dec(p, cache, tokens[:, i], pos + i)
            outs.append(full(lg))
        p, opt, m = tr(p, opt, batch)
        torch.cuda.synchronize()
        outs += [m["loss"]] + [full(t) for t in tree_leaves(p)]
        return outs, flash_attention.launches - flash, decode_attention.launches - decode

    ref, rf, rd = run(None)
    with launcher_mesh(1, 1, card) as mesh:
        got, gf, gd = run(mesh)
    assert (gf, gd) == (rf, rd) == (cfg.n_layers * 3, cfg.n_layers * 2)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_moe_decode_on_a_1x1_mesh_equals_the_one_device_decode(card):
    """qwen2-moe's smoke config in bf16 at heads of 128: four decode steps
    through the sharded factory on a 1 x 1 mesh (a world of one NCCL rank)
    equal the ``mesh=None`` steps bit for bit (logits and cache), the MoE
    grouped by expert on the rank's local tensors, and launch the decode
    kernel inside ``local_map`` as often."""
    from repro_torch.launch.mesh import launcher_mesh
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime.steps import full, make_decode_step

    cfg = get_smoke_config("qwen2-moe-a2.7b").replace(d_head=128)
    params = tm.init_params(cfg, seed=6, device=card)
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (3, 4), generator=g, dtype=torch.int32).to(card)
    pos = torch.tensor([0, 5, 11], dtype=torch.int32, device=card)

    def run(mesh):
        dec = make_decode_step(cfg, 3, 16, card, mesh=mesh)
        p = params if mesh is None else dec.distribute(params)
        cache, outs, n = dec.init_cache(p), [], decode_attention.launches
        for i in range(4):
            logits, cache = dec(p, cache, tokens[:, i], pos + i)
            outs.append(full(logits))
        torch.cuda.synchronize()
        return outs + [full(t) for t in tree_leaves(cache)], decode_attention.launches - n

    ref, n_ref = run(None)
    with launcher_mesh(1, 1, card) as mesh:
        got, n_got = run(mesh)
    assert n_got == n_ref == 4 * cfg.n_layers
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
