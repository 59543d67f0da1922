"""``repro_torch.launch.mesh`` and the roofline's cost counters: meshes on
fake worlds and their rank blocks, ``roofline_terms`` against the
reference's, ``collective_stats`` against ``parse_collectives`` on the same
collectives, and per-chip flops on a fake (2, 2) world against a hand
count of the local products (not the global count a DTensor op shows)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro.launch import roofline as jroof
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.mesh import (
    fake_world, make_production_mesh, make_test_mesh, slice_mesh, slice_meshes,
)


@pytest.fixture(autouse=True)
def _no_process_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    n = 512 if multi_pod else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert mesh.mesh.flatten().tolist() == list(range(n))
        assert list(mesh.get_coordinate()) == [0] * mesh.ndim


def test_test_mesh_and_slices():
    with fake_world(256):
        assert make_test_mesh(2, 2, "cpu").mesh.tolist() == [[0, 1], [2, 3]]
        pod = make_production_mesh(device_type="cpu")
        s = slice_mesh(pod, 4, 8)
        assert s.mesh_dim_names == ("data", "model") and tuple(s.shape) == (4, 16)
        assert s.mesh.tolist() == np.arange(64, 128).reshape(4, 16).tolist()
        parts = slice_meshes(pod, [2, 6, 8])
        assert [tuple(p.shape) for p in parts] == [(2, 16), (6, 16), (8, 16)]
        assert [int(p.mesh[0, 0]) for p in parts] == [0, 32, 128]
        with pytest.raises(AssertionError):
            slice_meshes(pod, [10, 7])


def test_fake_world_refuses_a_second_group_and_cleans_up():
    with fake_world(4):
        with pytest.raises(RuntimeError):
            with fake_world(4):
                pass
    assert not dist.is_initialized()


@pytest.mark.parametrize("flops", [0.0, 1e12, 3.3e15])
@pytest.mark.parametrize("nbytes", [0.0, 5e9, 7e11])
@pytest.mark.parametrize("coll", [0.0, 2e8, 9e10])
def test_roofline_terms_match_reference(flops, nbytes, coll):
    assert roofline.roofline_terms(flops, nbytes, coll) == jroof.roofline_terms(flops, nbytes, coll)
    assert roofline.HBM_BYTES == jroof.HBM_BYTES
    assert roofline._COLLECTIVE_WEIGHT == jroof._COLLECTIVE_WEIGHT


HLO_SNIPPET = """
  %p0 = bf16[16,4096]{1,0} parameter(0)
  %ag = bf16[16,4096]{1,0} all-gather(%p0), replica_groups={}
  %ar = (f32[8,8]{1,0}, f32[4]{0}) all-reduce(%x, %y), to_apply=%add
  %a2a = bf16[2,64]{1,0} all-to-all(%z), dimensions={0}
  %d = f32[8,8]{1,0} dot(%ar, %ar), lhs_contracting_dims={1}
"""


def test_collective_stats_match_parse_collectives():
    """The snippet's collectives run on a fake world of 16 under the
    counter: an all-gather to bf16[16,4096], one (coalesced) all-reduce of
    f32[8,8] and f32[4], an all-to-all of bf16[2,64]."""
    with fake_world(16):
        group = dist.group.WORLD
        with roofline.CostCounter() as c:
            split = [2] + [0] * 15
            outs = [funcol.all_gather_single(torch.ones(1, 4096, dtype=torch.bfloat16), 0, group),
                    *funcol.all_reduce_coalesced([torch.ones(8, 8), torch.ones(4)], "sum", group),
                    funcol.all_to_all_single(torch.ones(2, 64, dtype=torch.bfloat16), split, split,
                                             group)]
            for t in outs:
                funcol.wait_tensor(t)
    got, want = c.stats(), jroof.parse_collectives(HLO_SNIPPET)
    assert (got.bytes_raw, got.bytes_weighted, got.count) == (
        want.bytes_raw, want.bytes_weighted, want.count)
    assert got.by_op == want.by_op


def _visible(sq, skv):
    return sum(min(max(i + skv - sq + 1, 0), skv) for i in range(sq))


def test_flash_cost_counts_visible_pairs():
    from repro_torch.kernels.flash_attention.ops import _visible_pairs

    for sq, skv in [(1, 1), (7, 7), (5, 9), (9, 5), (128, 1000)]:
        assert _visible_pairs(sq, skv, True) == _visible(sq, skv)
        assert _visible_pairs(sq, skv, False) == sq * skv


def test_flops_per_chip_are_local_on_a_fake_2x2_world():
    """The smoke llama3 prefill at one layer on a (2, 2) mesh: every
    product on rank 0's shard (batch over "data", heads and the MLP over
    "model", the GQA kv projections replicated), plus the flash kernel's
    formula, and the last position's logits."""
    cfg = get_smoke_config("llama3-8b").replace(n_layers=1)
    B, S = 4, 16
    M, Hq, Hkv, D, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
                           cfg.vocab_size)
    with fake_world(4):
        mesh = make_test_mesh(2, 2, "cpu")
        rec = trace_step(cfg, ShapeConfig("t", S, B, "prefill"), mesh)
    b, t = B // 2, B // 2 * S
    hand = (2 * t * M * (Hq * D // 2)            # q
            + 2 * 2 * t * M * (Hkv * D)           # k, v: replicated on "model"
            + 4 * b * (Hq // 2) * D * (S * (S + 1) // 2)   # flash, causal
            + 2 * t * (Hq * D // 2) * M           # o
            + 3 * 2 * t * M * (F // 2)            # gate, up, down
            + 2 * b * M * (V // 2))               # last position's logits
    assert rec["flops"] == hand
    assert rec["kernels"]["flash_attention"][0] == 1
    global_count = (2 * B * S * M * (Hq + 2 * Hkv) * D + 4 * B * Hq * D * S * (S + 1) // 2
                    + 2 * B * S * Hq * D * M + 6 * B * S * M * F + 2 * B * M * V)
    assert rec["flops"] < global_count / 2


def test_the_kernel_stand_in_is_only_for_fake_tensors():
    """On real tensors the wrappers run their plain version (CPU), with the
    counter paused there: its products are not counted, the formula is."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 4, 16, generator=g) for _ in range(3))
    with roofline.CostCounter() as c:
        out = flash_attention(q, k, v)
    torch.testing.assert_close(out, flash_attention_plain(q, k, v))
    assert c.flops == 4 * 4 * 16 * (8 * 9 // 2) and c.kernels["flash_attention"][0] == 1
    qd, cache = torch.randn(2, 4, 16, generator=g), torch.randn(2, 10, 2, 16, generator=g)
    lengths = torch.tensor([3, 10], dtype=torch.int32)
    with roofline.CostCounter() as c:
        out = decode_attention(qd, cache, cache, lengths)
    assert out.abs().sum() > 0 and c.flops == 4 * 2 * 4 * 16 * 10


def test_model_made_tensors_and_the_sharded_ce_move_nothing():
    """On a fake (2, 2) world: RoPE with plain positions and tables beside
    a head-sharded DTensor (``implicit_replication``) issues no collective,
    and the vocab-sharded CE reduces (B, S) rows only: no all-gather of the
    logits."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.layers import apply_rope
    from repro_torch.models.model import _sharded_lse_gold

    with fake_world(4):
        mesh = make_test_mesh(2, 2, "cpu")
        q = distribute_tensor(torch.randn(4, 8, 4, 16), mesh, [Shard(0), Shard(2)])
        logits = distribute_tensor(torch.randn(4, 8, 64), mesh, [Shard(0), Shard(2)])
        labels = distribute_tensor(torch.randint(0, 64, (4, 8)), mesh, [Shard(0), Replicate()])
        with implicit_replication(), CommDebugMode() as comm:
            apply_rope(q, torch.arange(8)[None, :], 10000.0)
        assert comm.get_total_counts() == 0
        with roofline.CostCounter() as c:
            lse, gold = _sharded_lse_gold(logits, labels)
            ce = lse - gold
        names = {name for name, _, _ in c.collectives}
        assert "all_reduce" in names and names <= {"all_reduce", "reduce_scatter_tensor"}, names
        assert max(b for _, b, _ in c.collectives) <= 2 * 8 * 4       # (B / 2, S) f32 rows
        assert ce.shape == (4, 8)


def test_kernel_formulas_at_heads_of_64_and_for_cross_attention():
    """The formulas at seamless's heads of 64: the encoder's flash call
    (non-causal), cross-attention's (Sq != Skv, every pair visible) and
    both decode calls (self-attention, and cross-attention over the
    encoder's frames): ``4 D`` a visible pair or cache slot and q head."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator().manual_seed(0)
    for sq, skv, causal in [(9, 9, False), (5, 13, False), (5, 13, True)]:
        q, k = torch.randn(2, sq, 4, 64, generator=g), torch.randn(2, skv, 4, 64, generator=g)
        with roofline.CostCounter() as c:
            flash_attention(q, k, k, causal=causal)
        assert c.flops == 4 * 2 * 4 * 64 * (_visible(sq, skv) if causal else sq * skv)
        assert c.bytes == 2 * q.numel() * 4 + 2 * k.numel() * 4
    qd, cache = torch.randn(3, 4, 64, generator=g), torch.randn(3, 11, 4, 64, generator=g)
    with roofline.CostCounter() as c:
        decode_attention(qd, cache, cache, torch.tensor([11, 3, 6], dtype=torch.int32))
    assert c.flops == 4 * 3 * 4 * 64 * 11


def _slstm(gen):
    from repro_torch.models.xlstm import _slstm_loop

    H, dh = 2, 8
    wx, r = torch.randn(3, 7, 4 * H * dh, generator=gen), torch.randn(H, 4, dh, dh, generator=gen)
    return lambda wx, r: _slstm_loop(wx, r, H), [wx, r]


def _mamba(gen):
    from repro_torch.models.mamba import _scan

    B, S, D, N = 2, 12, 5, 3
    dt, x1f = (torch.rand(B, S, D, generator=gen) for _ in range(2))
    Bs, Cs = (torch.randn(B, S, N, generator=gen) for _ in range(2))
    return (lambda *t: _scan(*t, 4),
            [dt, Bs, Cs, x1f, -torch.rand(D, N, generator=gen), torch.randn(D, generator=gen)])


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("loop", [_slstm, _mamba], ids=["slstm", "mamba"])
def test_loop_traced_once_counts_the_loop(loop, grad):
    """A dry run's fake tensors trace the sLSTM's token loop (and the Mamba
    scan's chunk loop) for the first trip once and count it once a trip
    (``roofline.TracedLoop``): the flops and the bytes of the major ops
    equal those of the loop run trip by trip on real tensors, forward and
    (the carry's gradient left out at the first trip) backward; so do the
    raw bytes of the forward.  The raw bytes of the backward (gradient
    sums) and the live bytes are near, not equal."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def count(fake):
        fn, args = loop(torch.Generator().manual_seed(0))
        mode = FakeTensorMode() if fake else None
        with mode if fake else torch.enable_grad():
            if fake:
                args = [mode.from_tensor(t) for t in args]
            args = [t.requires_grad_(grad) for t in args]
            with roofline.CostCounter(existing=args) as c:
                out = fn(*args)
                if grad:
                    torch.autograd.grad(out.sum(), args)
        return c

    real, traced = count(False), count(True)
    assert (traced.flops, traced.bytes) == (real.flops, real.bytes) and real.flops > 0
    if not grad:
        assert traced.bytes_raw == real.bytes_raw
    assert abs(traced.bytes_raw / real.bytes_raw - 1) < 0.2
    assert abs(traced.peak / real.peak - 1) < 0.3
