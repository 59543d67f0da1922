"""Dense MLP blocks: SwiGLU (the decoder families) and GELU (the
encoder-decoder); port of ``repro/models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, pdtype
from repro_torch.sharding import constrain

# the hidden activation's logical axes: a sequence (B, S, F), or a decode step's (B, F)
_MLP_AXES = {3: ("act_batch", "act_seq", "act_mlp"), 2: ("act_batch", "act_mlp")}


def init_swiglu(generator, cfg, layers: int | None = None, device="cuda",
                d_ff: int | None = None) -> dict:
    dt = pdtype(cfg)
    M, Fd = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": dense_init(generator, (M, Fd), dt, layers=layers, device=device),
        "wu": dense_init(generator, (M, Fd), dt, layers=layers, device=device),
        "wd": dense_init(generator, (Fd, M), dt, layers=layers, device=device),
    }


def swiglu_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["wg"])
    u = x @ p["wu"]
    h = constrain(g * u, _MLP_AXES[x.ndim])
    return h @ p["wd"]


def init_gelu_mlp(generator, cfg, layers: int | None = None, device="cuda",
                  d_ff: int | None = None) -> dict:
    dt = pdtype(cfg)
    M, Fd = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wu": dense_init(generator, (M, Fd), dt, layers=layers, device=device),
        "wd": dense_init(generator, (Fd, M), dt, layers=layers, device=device),
    }


def gelu_mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``gelu(x wu) wd`` with the tanh approximation (``jax.nn.gelu``'s
    default, ``approximate=True``)."""
    h = F.gelu(x @ p["wu"], approximate="tanh")
    h = constrain(h, _MLP_AXES[x.ndim])
    return h @ p["wd"]
