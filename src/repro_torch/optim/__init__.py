"""Optimizer of the port: AdamW with f32 master weights (``repro/optim``)."""
from repro_torch.optim.adamw import (
    OptConfig, adamw_update, global_norm, init_opt_state, lr_at, tree_leaves, tree_map,
    tree_unflatten,
)

__all__ = ["OptConfig", "adamw_update", "global_norm", "init_opt_state", "lr_at",
           "tree_leaves", "tree_map", "tree_unflatten"]
