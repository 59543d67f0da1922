"""SwiGLU MLP block of the decoder families (port of ``repro/models/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, pdtype


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
    return (g * u) @ p["wd"]
