"""Forward flash attention (GQA, optional right-aligned causal mask).

Port of ``repro/kernels/flash_attention``.  :func:`flash_attention` takes
the reference wrapper's layout — q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) —
and launches the CUDA kernel of ``csrc/flash_attention.cu`` for tensors on
the card: for bfloat16 the tensor cores (TMA loads and wgmma products, so
q, k, v and the output must start on a 16-byte boundary), for float32 the
CUDA cores; heads of 64 or 128.
:func:`flash_attention_plain` is the same function in plain PyTorch; the
wrapper uses it only for tensors on the CPU.

Contract: query i sits at position ``i + Skv - Sq`` (right-aligned, as a
prefill continuation), the kv head of q head h is ``h // (Hq // Hkv)``, and
a row with no visible key gives 0.

Counting: the wrapper reports the kernel's flops and bytes to an active
``repro_torch.launch.roofline.CostCounter`` (:func:`flash_cost`); on fake
tensors (a dry run's trace) it returns an empty output of the right shape
and computes nothing.

Gradients: :func:`flash_attention` runs through an autograd Function
whose forward is that dispatch and whose backward is
:func:`flash_attention_bwd`, written in PyTorch tensor ops and the same on
both devices (with grad disabled, or no input requiring it, the Function
records no graph).  The reference has no backward kernel: XLA differentiates
its chunked jnp form (``repro/kernels/flash_attention/ref.py``).
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

from repro_torch.kernels import build
from repro_torch.launch import roofline

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_SIZES = (64, 128)   # the kernel's D: seamless-m4t's heads and the others'
_Q_CHUNK = 2048   # query rows per dense product in the plain version
_BWD_Q_CHUNK = 512   # query rows per recomputed score block in the backward


def flash_attention_plain(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    Dense f32 scores, one kv head and ``_Q_CHUNK`` query rows at a time so
    that a long prefill does not hold all (Sq, Skv) scores of every head."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    out = torch.empty((B, Sq, Hq, D), dtype=torch.float32, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    for h in range(Hkv):
        kh = k[:, :, h].float()                                   # (B, Skv, D)
        vh = v[:, :, h].float()
        for lo in range(0, Sq, _Q_CHUNK):
            hi = min(Sq, lo + _Q_CHUNK)
            qh = q[:, lo:hi, h * g:(h + 1) * g].float()           # (B, sq, g, D)
            logits = torch.einsum("bqgd,bkd->bgqk", qh, kh) * scale
            if causal:
                qpos = torch.arange(lo, hi, device=q.device)[:, None] + (Skv - Sq)
                logits = logits.masked_fill(~(qpos >= kpos[None, :]), -torch.inf)
            m = logits.amax(dim=-1, keepdim=True)
            m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))   # fully masked rows
            p = torch.exp(logits - m)
            den = p.sum(dim=-1, keepdim=True)
            o = torch.einsum("bgqk,bkd->bqgd", p / den.clamp_min(1e-30), vh)
            out[:, lo:hi, h * g:(h + 1) * g] = o
    return out.to(q.dtype)


def _visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the right-aligned causal mask lets through."""
    if not causal:
        return sq * skv

    def f(n):   # sum over j = 1..n of min(j, skv)
        if n <= 0:
            return 0
        m = min(n, skv)
        return m * (m + 1) // 2 + (n - m) * skv

    return f(skv) - f(skv - sq)


def flash_cost(q, k, causal: bool) -> tuple[float, float]:
    """``(flops, bytes)`` of one kernel call: ``4 D`` a visible pair and q
    head (QK^T and PV), each input read once and the output written once."""
    B, Sq, Hq, D = q.shape
    flops = 4.0 * B * Hq * D * _visible_pairs(Sq, k.shape[1], causal)
    return flops, 2.0 * q.numel() * q.element_size() + 2.0 * k.numel() * k.element_size()


def _flash_forward(q, k, v, causal: bool, scale: float | None):
    return roofline.kernel_call("flash_attention", lambda: flash_cost(q, k, causal), _flash_run,
                                q, k, v, causal, scale)


def _flash_run(q, k, v, causal: bool, scale: float | None):
    """The CUDA kernel for tensors on the card, the plain version for
    tensors on the CPU, an empty output for fake tensors."""
    if isinstance(q, FakeTensor):
        return torch.empty_like(q)
    if isinstance(q, DTensor):
        raise TypeError("flash_attention: the kernel takes one rank's local tensors, "
                        "not a DTensor")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    B, Sq, Hq, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_attention: tensors on {q.device} and {t.device}")
    if (Bk, Dk) != (B, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if Hq % Hkv or D not in _HEAD_SIZES or Sq == 0 or Skv == 0:
        raise ValueError(f"flash_attention: Hq={Hq}, Hkv={Hkv}, D={D}, Sq={Sq}, Skv={Skv} "
                         "not supported")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: tensors must be contiguous")
    build.require_sm90(q)
    out = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} does not start on a 16-byte boundary")
    launch = build.load("flash_attention")
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, Hq, Hkv, D, _DTYPE_CODE[q.dtype], int(causal),
        ctypes.c_float(1.0 / (D ** 0.5) if scale is None else scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


def _heads_first(t, Hkv: int):
    """(B, S, Hkv * g, D) -> f32 (B, Hkv, S * g, D): one kv head's query
    rows, each position's g heads side by side, as one matrix."""
    B, S, H, D = t.shape
    return t.float().reshape(B, S, Hkv, H // Hkv, D).transpose(1, 2).reshape(B, Hkv, -1, D)


def _like(t, dtype):
    """A contiguous copy of ``t`` in ``dtype`` (one pass)."""
    return torch.empty(t.shape, dtype=dtype, device=t.device).copy_(t)


@torch.no_grad()
def flash_attention_bwd(q, k, v, out, dout, causal: bool = True, scale: float | None = None):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` (FlashAttention-2's
    backward), in the dtypes of q, k and v.

    For each block of ``_BWD_Q_CHUNK`` query rows and each kv head the
    scores are recomputed in f32 against the keys the block can see, and

        P  = softmax(scale * Q K^T)         (right-aligned causal mask)
        dV += P^T dO,   dP = dO V^T,   Delta = rowsum(dO * O),
        dS = P * (dP - Delta),
        dQ = scale * dS K,   dK += scale * dS^T Q,

    all in f32.  A kv head's g query heads are stacked as rows of one
    matrix, so each product covers them at once and dK and dV sum over
    them; a block is some 15 launches.  A row with no visible key has
    P = 0 and gets zero gradients."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    assert Hq % Hkv == 0, (Hq, Hkv)
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    dev = q.device
    qs = _heads_first(q, Hkv).mul_(scale)                     # (B, Hkv, Sq*g, D), scaled
    do = _heads_first(dout, Hkv)
    delta = _heads_first((dout.float() * out.float()).sum(-1, keepdim=True), Hkv)
    kf, vf = (t.float().transpose(1, 2).contiguous() for t in (k, v))   # (B, Hkv, Skv, D)
    ks = kf * scale
    dq = torch.zeros((B, Hkv, Sq * g, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Hkv, Skv, D), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, Hkv, Skv, D), dtype=torch.float32, device=dev)
    for lo in range(0, Sq, _BWD_Q_CHUNK):
        hi = min(Sq, lo + _BWD_Q_CHUNK)
        # keys past the block's last visible one take no part
        kv_hi = min(Skv, hi + Skv - Sq) if causal else Skv
        if kv_hi <= 0:
            continue                                          # no row sees a key
        rows = slice(lo * g, hi * g)
        if causal:
            qpos = (torch.arange(lo, hi, device=dev) + (Skv - Sq)).repeat_interleave(g)
            masked = qpos[:, None] < torch.arange(kv_hi, device=dev)[None, :]
        for h in range(Hkv):
            kh, vh = kf[:, h, :kv_hi], vf[:, h, :kv_hi]       # (B, kv, D)
            qh, doh = qs[:, h, rows], do[:, h, rows]          # (B, sq*g, D)
            s = torch.bmm(qh, kh.mT)                          # (B, sq*g, kv)
            if causal:
                s.masked_fill_(masked, -torch.inf)
            m = s.amax(dim=-1, keepdim=True).nan_to_num_(neginf=0.0)   # fully masked rows
            p = s.sub_(m).exp_()
            p.div_(p.sum(dim=-1, keepdim=True).clamp_min_(1e-30))
            dv[:, h, :kv_hi].baddbmm_(p.mT, doh)
            ds = torch.bmm(doh, vh.mT).sub_(delta[:, h, rows]).mul_(p)
            torch.bmm(ds, ks[:, h, :kv_hi], out=dq[:, h, rows])
            dk[:, h, :kv_hi].baddbmm_(ds.mT, qh)
    dq = dq.reshape(B, Hkv, Sq, g, D).transpose(1, 2).reshape(B, Sq, Hq, D)
    return _like(dq, q.dtype), _like(dk.transpose(1, 2), k.dtype), _like(dv.transpose(1, 2),
                                                                            v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The forward dispatch of :func:`flash_attention` with
    :func:`flash_attention_bwd` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out = _flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention_bwd"):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None):
    """Flash attention; the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU, differentiable through
    :func:`flash_attention_bwd`.
    ``flash_attention.launches`` counts kernel launches (forward only)."""
    return _FlashAttention.apply(q, k, v, causal, scale)


flash_attention.launches = 0
