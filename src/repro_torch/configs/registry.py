"""Architecture registry: ``--arch <id>`` lookup, cell enumeration, skips."""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

# arch id -> module path (one module per assigned architecture)
_ARCH_MODULES: dict[str, str] = {
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}

ARCH_IDS: tuple[str, ...] = tuple(_ARCH_MODULES)
SHAPE_IDS: tuple[str, ...] = tuple(SHAPES)


def get_config(arch: str) -> ModelConfig:
    """Full (production) config for an assigned architecture id."""
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).FULL


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).SMOKE


def get_shape(shape: str) -> ShapeConfig:
    return SHAPES[shape]


@dataclass(frozen=True)
class Cell:
    """One (architecture x input-shape) dry-run cell."""

    arch: str
    shape: str
    skip: str = ""               # non-empty -> documented skip reason

    @property
    def runnable(self) -> bool:
        return not self.skip


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """Documented skip logic (see DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "pure full-attention arch: 500k-token decode requires a "
            "sub-quadratic path (run only for SSM/hybrid archs)"
        )
    return ""


def all_cells() -> list[Cell]:
    """The 40 assigned (arch x shape) cells, with skip annotations."""
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape_id in SHAPE_IDS:
            cells.append(Cell(arch, shape_id, cell_skip_reason(cfg, SHAPES[shape_id])))
    return cells


def runnable_cells() -> list[Cell]:
    return [c for c in all_cells() if c.runnable]
