"""Plain PyTorch pieces of the reference, in float32 with TF32 off.

``Precision`` is where the control differs from the reference: in
``"fp8"`` every operand of a product (a layer's input and weight, the
attention's q, k and v) is rounded to float8 e4m3 with one scale a tensor
before an f32 product, the step below the bf16 that the configurations
state.  Nothing here imports the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def strict_f32() -> None:
    """Products in true f32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def r(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in f32, rounded through float8 e4m3 in ``"fp8"`` mode."""
        t = t.float()
        if self.mode == "f32":
            return t
        s = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (t / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.r(x) @ self.r(w)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (..., S, H, D) at positions ``pos`` (..., S):
    the first and second halves of each head as the two coordinates."""
    d = x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[..., None] * inv                       # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def attention(q, k, v, pr: Precision, *, causal: bool, q_block: int = 1024):
    """Softmax attention of q (B, Sq, H, D) over k, v (B, Skv, Hkv, D),
    query i at position ``i + Skv - Sq``; in blocks of ``q_block`` queries.
    Returns (B, Sq, H, D) f32."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    kh = pr.r(k).repeat_interleave(g, dim=2).transpose(1, 2)      # (B, H, Skv, D)
    vh = pr.r(v).repeat_interleave(g, dim=2).transpose(1, 2)
    qh = pr.r(q).transpose(1, 2)                                  # (B, H, Sq, D)
    out = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    for lo in range(0, Sq, q_block):
        hi = min(Sq, lo + q_block)
        s = (qh[:, :, lo:hi] @ kh.transpose(-1, -2)) / math.sqrt(D)
        if causal:
            qpos = torch.arange(lo, hi, device=q.device) + (Skv - Sq)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], -torch.inf)
        out[:, :, lo:hi] = torch.softmax(s, dim=-1) @ vh
    return out.transpose(1, 2)


def attend_rows(q, k, v, lengths, pr: Precision):
    """One query a row: q (B, H, D) over the first ``lengths[b]`` keys of
    k, v (B, S, Hkv, D).  Returns (B, H, D) f32."""
    B, H, D = q.shape
    g = H // k.shape[2]
    kh = pr.r(k).repeat_interleave(g, dim=2)                      # (B, S, H, D)
    vh = pr.r(v).repeat_interleave(g, dim=2)
    s = torch.einsum("bhd,bshd->bhs", pr.r(q), kh) / math.sqrt(D)
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, :], -torch.inf)
    return torch.einsum("bhs,bshd->bhd", torch.softmax(s, dim=-1), vh)


def swiglu(x, wg, wu, wd, pr: Precision):
    return pr.mm(F.silu(pr.mm(x, wg)) * pr.mm(x, wu), wd)


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a tree of stacked leaves."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}
