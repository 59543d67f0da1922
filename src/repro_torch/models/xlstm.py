"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, strictly sequential).  Port of ``repro/models/xlstm.py``.

The mLSTM training path uses the reference's *chunked* parallel form: a
loop over sequence chunks carrying the stabilized (C, n, m) state, with an
intra-chunk quadratic gate matrix (chunked gated linear attention).  The
step-by-step form (:func:`mlstm_sequential`) is the oracle of the tests.

Math (stabilized, per head; b = intra-chunk cumsum of log-f, g = cummax of
(log-i − b)):
    m_t   = b_t + M_t,  M_t = max(m_0, g_t)
    num_t = Σ_{s≤t} exp(li_s − b_s − M_t) (q_t·k_s) v_s + exp(m_0 − M_t) q_t C_0
    den_t = Σ_{s≤t} exp(li_s − b_s − M_t) (q_t·k_s)     + exp(m_0 − M_t) q_t n_0
    h_t   = o_t ⊙ num_t / max(|den_t|, exp(−m_t))

The casts sit where the reference puts them: the gates, q, k, v, the
recurrences and the sLSTM input product run in f32 inside a bf16 model, and
h goes back to the input dtype before the output projection.  Every maximum
is ``torch.maximum`` of two tensors, whose gradient at a tie is split half
and half as ``jax.grad``'s is (``clamp_min`` would give all of it to the
input).  The sLSTM recurrence is a Python loop over tokens, as the
reference's ``lax.scan`` is a loop; the reference has no kernel for it.
The chunk loop and the sLSTM loop are marked for ``torch.profiler``
(``mlstm_chunks``, ``slstm_loop``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.launch import roofline
from repro_torch.models.layers import (
    causal_conv1d, conv1d_step, dense_init, halves, pdtype, residual, rmsnorm,
)
from repro_torch.sharding import constrain
from repro_torch.sharding.specs import on_batch_shards

NEG = -1e30


def m_inner(cfg) -> int:
    return int(cfg.xlstm.expand_m * cfg.d_model)


def s_ff(cfg) -> int:
    return int(round(cfg.xlstm.proj_factor_s * cfg.d_model))


def _lead(layers: int | None) -> tuple:
    return () if layers is None else (layers,)


def _stacked(row: torch.Tensor, layers: int | None) -> torch.Tensor:
    """``row`` repeated on a leading ``layers`` axis, as a real tensor."""
    return row if layers is None else row.expand(layers, *row.shape).clone()


# ===========================================================================
# mLSTM block
# ===========================================================================

def init_mlstm(generator, cfg, layers: int | None = None, device="cuda") -> dict:
    dt = pdtype(cfg)
    M, D, H = cfg.d_model, m_inner(cfg), cfg.n_heads
    lead = _lead(layers)

    def w(shape, dtype=dt):
        return dense_init(generator, shape, dtype, layers=layers, device=device)

    f32 = torch.float32
    return {
        "norm": torch.ones((*lead, M), dtype=f32, device=device),
        "w_up": w((M, 2 * D)),
        "conv_w": w((cfg.xlstm.d_conv, D)),
        "conv_b": torch.zeros((*lead, D), dtype=dt, device=device),
        "wq": w((D, D)),
        "wk": w((D, D)),
        "wv": w((D, D)),
        "w_gates": w((D, 2 * H), f32),                       # i, f pre-activations
        "b_gates": _stacked(torch.cat([torch.zeros(H, dtype=f32, device=device),
                                       torch.linspace(3.0, 6.0, H, dtype=f32, device=device)]),
                            layers),
        "onorm": torch.ones((*lead, D), dtype=f32, device=device),   # post-memory norm scale
        "w_down": w((D, M)),
    }


def _heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(..., D) -> (..., H, D // H).  Under a mesh the features are
    gathered first and the batch stays sharded: the recurrences run on
    batch shards, and 4 heads do not divide a model axis of 16."""
    t = constrain(t, ("act_batch", "act_seq", None) if t.ndim == 3 else ("act_batch", None))
    return t.reshape(*t.shape[:-1], H, t.shape[-1] // H)


def _mlstm_qkv_gates(p, x, cfg):
    """x: (B, S, M) -> q, k, v (B, S, H, dh), gates li, lf (B, S, H) f32, z (B, S, D)."""
    H = cfg.n_heads
    D = m_inner(cfg)
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    up = xn @ p["w_up"]
    xm, z = halves(up)                                     # (B, S, D)
    c = F.silu(causal_conv1d(xm, p["conv_w"], p["conv_b"]))
    q = _heads(c @ p["wq"], H)
    k = _heads(c @ p["wk"], H) * (D // H) ** -0.5
    v = _heads(xm @ p["wv"], H)
    gates = c.float() @ p["w_gates"] + p["b_gates"]
    li, lf_pre = halves(gates)                             # (B, S, H)
    return q, k, v, li, on_batch_shards(F.logsigmoid, lf_pre), z


def _mlstm_finish(p, h, z, x, cfg):
    B, S = x.shape[:2]
    # the heads merged; under a mesh the gradient is gathered before it is
    # split into heads again (4 heads do not divide a model axis of 16)
    h = constrain(h.reshape(B, S, -1), ("act_batch", "act_seq", None))
    h = rmsnorm(h, p["onorm"], cfg.norm_eps)                      # the xLSTM block's GN
    return residual(x + (h.to(x.dtype) * F.silu(z)) @ p["w_down"])


def _mlstm_chunk(carry, qk, kk, vk, lik, lfk):
    """One chunk of the parallel form: inputs (B, c, H, ...) f32, carry
    (C0 (B, H, dh, dh), n0 (B, H, dh), m0 (B, H)).  Returns the new carry
    and h (B, c, H, dh)."""
    C0, n0, m0 = carry
    c = qk.shape[1]
    b = torch.cumsum(lfk, dim=1)                           # (B, c, H)
    a = lik - b
    g = torch.cummax(a, dim=1).values
    Mt = torch.maximum(m0[:, None], g)                     # (B, c, H)
    m_t = b + Mt

    # intra-chunk gate matrix D[t, s] = exp(a_s - M_t) for s <= t; the mask
    # goes inside the exp: above the diagonal a_s - M_t can overflow, and
    # inf * 0 in the backward would be NaN
    tri = torch.ones((c, c), dtype=torch.bool, device=qk.device).tril()
    Dmat = torch.exp(torch.where(tri[None, :, :, None], a[:, None] - Mt[:, :, None], NEG))
    s = torch.einsum("bthd,bshd->btsh", qk, kk)            # (B, c, c, H)
    w = s * Dmat
    num_intra = torch.einsum("btsh,bshd->bthd", w, vk)
    den_intra = w.sum(dim=2)                               # (B, c, H)
    carry_w = torch.exp(m0[:, None] - Mt)                  # (B, c, H)
    qC = torch.einsum("bthd,bhde->bthe", qk, C0)
    qn = torch.einsum("bthd,bhd->bth", qk, n0)
    num = num_intra + carry_w[..., None] * qC
    den = den_intra + carry_w * qn
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    # carry to the next chunk (stabilizer m_new = m at the chunk's end)
    M_end = torch.maximum(m0, g[:, -1])                    # (B, H)
    e = torch.exp(a - M_end[:, None])                      # (B, c, H)
    kv = torch.einsum("bshd,bshe->bhde", kk * e[..., None], vk)
    ksum = torch.einsum("bshd,bsh->bhd", kk, e)
    decay0 = torch.exp(m0 - M_end)                         # (B, H)
    C_new = decay0[..., None, None] * C0 + kv
    n_new = decay0[..., None] * n0 + ksum
    return (C_new, n_new, b[:, -1] + M_end), h


def _zero_mlstm_carry(B, H, dh, device):
    f32 = torch.float32
    return (torch.zeros((B, H, dh, dh), dtype=f32, device=device),
            torch.zeros((B, H, dh), dtype=f32, device=device),
            torch.full((B, H), NEG, dtype=f32, device=device))


def mlstm_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Chunk-parallel mLSTM forward. x: (B, S, M)."""
    q, k, v, li, lf, z = _mlstm_qkv_gates(p, x, cfg)
    h = on_batch_shards(lambda *t: _mlstm_chunks(*t, cfg.xlstm.chunk), q, k, v, li, lf)
    return _mlstm_finish(p, h, z, x, cfg)


def _mlstm_chunks(q, k, v, li, lf, chunk_len: int):
    """The chunk loop: q, k, v (B, S, H, dh), gates li, lf (B, S, H) ->
    h (B, S, H, dh) f32."""
    B, S, H, dh = q.shape
    chunk = min(chunk_len, S)
    pad = (-S) % chunk
    qp, kp, vp = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    lip, lfp = F.pad(li, (0, 0, 0, pad)), F.pad(lf, (0, 0, 0, pad))
    if pad:  # padded steps: i = -inf (no contribution), f = 0 (identity decay)
        mask = (torch.arange(S + pad, device=q.device) < S)[None, :, None]
        lip = torch.where(mask, lip, NEG)
        lfp = torch.where(mask, lfp, 0.0)

    # ``split`` (one backward node a tensor), not a slice per chunk, whose
    # backward would write a full-size gradient per chunk
    carry = _zero_mlstm_carry(B, H, dh, q.device)
    hs = []
    with torch.profiler.record_function("mlstm_chunks"):
        for inputs in zip(*(t.split(chunk, dim=1) for t in (qp, kp, vp, lip, lfp))):
            carry, h = _mlstm_chunk(carry, *inputs)
            hs.append(h)
        return torch.cat(hs, dim=1)[:, :S]                 # (B, S, H, dh)


def _mlstm_recur(C, n, m, qt, kt, vt, lit, lft):
    """One step of the stabilized recurrence on (B, H, ...) f32 tensors."""
    m_new = torch.maximum(lft + m, lit)
    fp = torch.exp(lft + m - m_new)
    ip = torch.exp(lit - m_new)
    C = fp[..., None, None] * C + ip[..., None, None] * (kt[..., :, None] * vt[..., None, :])
    n = fp[..., None] * n + ip[..., None] * kt
    num = torch.einsum("bhd,bhde->bhe", qt, C)
    den = torch.einsum("bhd,bhd->bh", qt, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return C, n, m_new, h


def mlstm_sequential(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Step-by-step oracle for the chunked form (tests)."""
    B = x.shape[0]
    H = cfg.n_heads
    dh = m_inner(cfg) // H
    q, k, v, li, lf, z = _mlstm_qkv_gates(p, x, cfg)
    q, k, v = q.float(), k.float(), v.float()
    C, n, m = _zero_mlstm_carry(B, H, dh, x.device)
    hs = []
    for step in zip(*(t.unbind(1) for t in (q, k, v, li, lf))):
        C, n, m, h = _mlstm_recur(C, n, m, *step)
        hs.append(h)
    return _mlstm_finish(p, torch.stack(hs, dim=1), z, x, cfg)


def init_mlstm_state(cfg, batch: int, layers: int | None = None, device="cuda") -> dict:
    H, dh = cfg.n_heads, m_inner(cfg) // cfg.n_heads
    lead = _lead(layers)
    f32 = torch.float32
    return {
        "C": torch.zeros((*lead, batch, H, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((*lead, batch, H, dh), dtype=f32, device=device),
        "m": torch.full((*lead, batch, H), NEG, dtype=f32, device=device),
        "conv": torch.zeros((*lead, batch, cfg.xlstm.d_conv - 1, m_inner(cfg)),
                            dtype=pdtype(cfg), device=device),
    }


def mlstm_decode(p: dict, x_t: torch.Tensor, state: dict, cfg) -> tuple[torch.Tensor, dict]:
    """One token. x_t: (B, M) -> (out (B, M), new state); ``state`` is not written."""
    B, _ = x_t.shape
    H = cfg.n_heads
    dh = m_inner(cfg) // H
    xn = rmsnorm(x_t, p["norm"], cfg.norm_eps)
    xm, z = halves(xn @ p["w_up"])
    c, conv_state = conv1d_step(xm, state["conv"], p["conv_w"], p["conv_b"])
    c = F.silu(c)
    q = _heads(c @ p["wq"], H).float()
    k = (_heads(c @ p["wk"], H) * dh ** -0.5).float()
    v = _heads(xm @ p["wv"], H).float()
    gates = c.float() @ p["w_gates"] + p["b_gates"]
    li, lf_pre = halves(gates)
    C, n, m, h = on_batch_shards(_mlstm_recur, state["C"], state["n"], state["m"], q, k, v, li,
                                 on_batch_shards(F.logsigmoid, lf_pre), n_out=4)
    h = rmsnorm(h.reshape(B, -1), p["onorm"], cfg.norm_eps)
    out = x_t + (h.to(x_t.dtype) * F.silu(z)) @ p["w_down"]
    return out, {"C": C, "n": n, "m": m, "conv": conv_state}


# ===========================================================================
# sLSTM block
# ===========================================================================

def init_slstm(generator, cfg, layers: int | None = None, device="cuda") -> dict:
    dt = pdtype(cfg)
    M, H = cfg.d_model, cfg.n_heads
    dh = M // H
    Fd = s_ff(cfg)
    lead = _lead(layers)
    f32 = torch.float32
    zeros = torch.zeros(M, dtype=f32, device=device)
    return {
        "norm": torch.ones((*lead, M), dtype=f32, device=device),
        "slstm_w": dense_init(generator, (M, 4 * M), f32, layers=layers, device=device),
        "slstm_r": dense_init(generator, (H, 4, dh, dh), f32, in_axis=2, layers=layers,
                              device=device) * 0.5,
        "slstm_b": _stacked(torch.cat([zeros, zeros,
                                       torch.linspace(3.0, 6.0, M, dtype=f32, device=device),
                                       zeros]), layers),
        "ffn_norm": torch.ones((*lead, M), dtype=f32, device=device),
        "w_up": dense_init(generator, (M, 2 * Fd), dt, layers=layers, device=device),
        "w_down": dense_init(generator, (Fd, M), dt, layers=layers, device=device),
    }


def _slstm_recur(pre, c, n, m, one):
    """The sLSTM cell on gate pre-activations ``pre`` (..., 4, dh) and state
    (..., dh), all f32: returns (h, c, n, m)."""
    zt, it, ft, ot = pre.unbind(-2)
    zt, ot = torch.tanh(zt), torch.sigmoid(ot)
    fm = ft + m
    m_new = torch.maximum(fm, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(fm - m_new)
    c_new = torch.addcmul(fp * c, ip, zt)
    n_new = torch.addcmul(ip, fp, n)
    return ot * c_new / torch.maximum(n_new, one), c_new, n_new, m_new


def _slstm_ffn(p, x, cfg):
    """The gated FFN after the cell (post-up-projection, factor 4/3)."""
    xn2 = rmsnorm(x, p["ffn_norm"], cfg.norm_eps)
    g, u = halves(xn2 @ p["w_up"])
    return residual(x + (F.gelu(g, approximate="tanh") * u) @ p["w_down"])


def slstm_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Sequential sLSTM + gated FFN. x: (B, S, M).  Under a mesh the
    recurrence runs on each rank's batch rows (its weights are replicated)."""
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    wx = xn.float() @ p["slstm_w"] + p["slstm_b"]          # (B, S, 4M), laid out (H, 4, dh)
    h = on_batch_shards(lambda wx, r: _slstm_loop(wx, r, cfg.n_heads), wx, p["slstm_r"],
                        whole=(1,))
    return _slstm_ffn(p, x + h.to(x.dtype), cfg)


def _slstm_loop(wx, r, H: int):
    """The recurrence over wx (B, S, 4M) with recurrent weights r (H, 4,
    dh, dh) -> h (B, S, M) f32.  It runs head-major, (H, B, ...), so that a
    token's recurrent product and its input term are one ``baddbmm``.  On
    a dry run's fake tensors one token is traced and counted once a token
    (``roofline.TracedLoop``)."""
    B, S, M4 = wx.shape
    dh = M4 // 4 // H
    wx = wx.reshape(B, S, H, 4 * dh).permute(1, 2, 0, 3)   # (S, H, B, 4 dh)
    r = r.permute(0, 2, 1, 3).reshape(H, dh, 4 * dh)       # r[h, d, g dh + e]
    one = torch.ones((), dtype=torch.float32, device=wx.device)

    def step(carry, wx_t, r):
        h, c, n, m = carry
        h, c, n, m = _slstm_recur(torch.baddbmm(wx_t, h, r).view(H, B, 4, dh), c, n, m, one)
        return (h, c, n, m), h

    def zero(distinct: bool):
        f32 = torch.float32
        h = torch.zeros((H, B, dh), dtype=f32, device=wx.device)
        c, n = (torch.zeros_like(h), torch.zeros_like(h)) if distinct else (h, h)
        return h, c, n, torch.full((H, B, dh), NEG, dtype=f32, device=wx.device)

    with torch.profiler.record_function("slstm_loop"):
        if isinstance(wx, FakeTensor) and S > 1:
            hs = roofline.TracedLoop.apply(step, zero, 0, 0, 1, wx, r)
        else:
            carry, steps = zero(False), []
            for wx_t in wx.unbind(0):      # one backward node, as ``split`` above
                carry, h = step(carry, wx_t, r)
                steps.append(h)
            hs = torch.stack(steps)
        # (S, H, B, dh) -> (B, S, M)
        return hs.permute(2, 0, 1, 3).reshape(B, S, H * dh)


def init_slstm_state(cfg, batch: int, layers: int | None = None, device="cuda") -> dict:
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    shape = (*_lead(layers), batch, H, dh)
    f32 = torch.float32
    return {"h": torch.zeros(shape, dtype=f32, device=device),
            "c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.zeros(shape, dtype=f32, device=device),
            "m": torch.full(shape, NEG, dtype=f32, device=device)}


def slstm_decode(p: dict, x_t: torch.Tensor, state: dict, cfg) -> tuple[torch.Tensor, dict]:
    """One token. x_t: (B, M) -> (out (B, M), new state); ``state`` is not written."""
    B, M = x_t.shape
    xn = rmsnorm(x_t, p["norm"], cfg.norm_eps)
    wx_t = xn.float() @ p["slstm_w"] + p["slstm_b"]
    h, c, n, m = on_batch_shards(lambda *t: _slstm_cell(*t, cfg.n_heads), wx_t, state["h"],
                                 state["c"], state["n"], state["m"], p["slstm_r"], whole=(5,),
                                 n_out=4)
    out = _slstm_ffn(p, x_t + h.reshape(B, M).to(x_t.dtype), cfg)
    return out, {"h": h, "c": c, "n": n, "m": m}


def _slstm_cell(wx_t, h, c, n, m, r, H: int):
    """One token's cell: input term wx_t (B, 4M), state (B, H, dh)."""
    rec = torch.einsum("bhd,hgde->bhge", h, r)
    pre = wx_t.reshape(wx_t.shape[0], H, 4, h.shape[-1]) + rec
    one = torch.ones((), dtype=torch.float32, device=wx_t.device)
    return _slstm_recur(pre, c, n, m, one)
