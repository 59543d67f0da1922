from repro_torch.configs.base import SHAPES, MambaCfg, ModelConfig, MoECfg, ShapeConfig, XLSTMCfg, scaled_shape
from repro_torch.configs.registry import (
    ARCH_IDS,
    SHAPE_IDS,
    Cell,
    all_cells,
    get_config,
    get_shape,
    get_smoke_config,
    runnable_cells,
)

__all__ = [
    "SHAPES",
    "ARCH_IDS",
    "SHAPE_IDS",
    "Cell",
    "MambaCfg",
    "ModelConfig",
    "MoECfg",
    "ShapeConfig",
    "XLSTMCfg",
    "all_cells",
    "get_config",
    "get_shape",
    "get_smoke_config",
    "runnable_cells",
    "scaled_shape",
]
