"""Config dataclasses for the model zoo and workload shapes.

Every assigned architecture is expressed as a ``ModelConfig``; the four
assigned input shapes are ``ShapeConfig``s.  Configs are frozen dataclasses so
they can be hashed into jit static args.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoECfg:
    """Mixture-of-experts block configuration (shared + routed experts)."""

    n_routed: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0            # expert FFN hidden size
    every: int = 1               # MoE replaces dense MLP every `every` layers
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3  # router z-loss coefficient
    aux_coef: float = 1e-2       # load-balance auxiliary loss coefficient
    impl: str = "gspmd"          # "gspmd" (sharding-constraint) | "ep" (shard_map all_to_all)


@dataclass(frozen=True)
class MambaCfg:
    """Mamba-1 selective SSM configuration."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 -> ceil(d_model/16)
    chunk: int = 256             # chunked-scan block length (train/prefill)


@dataclass(frozen=True)
class XLSTMCfg:
    """xLSTM block stack configuration (pattern of mLSTM / sLSTM blocks)."""

    pattern: str = "ms"          # repeated over the depth: m = mLSTM, s = sLSTM
    expand_m: float = 2.0        # mLSTM pre-up-projection factor
    proj_factor_s: float = 4.0 / 3.0  # sLSTM post-up-projection factor
    d_conv: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (decoder-only LM unless ``enc_dec``)."""

    name: str
    family: str                  # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 1_000_000.0
    moe: MoECfg | None = None
    mamba: MambaCfg | None = None
    attn_every: int = 0          # hybrid: 1 attention layer per `attn_every` layers
    xlstm: XLSTMCfg | None = None
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 0             # encoder frame length used with decode shapes
    sub_quadratic: bool = False  # supports long-context decode (SSM/hybrid)
    remat: str = "block"         # "none" | "block" (checkpoint each layer block)
    attn_impl: str = "auto"      # "auto" | "kernel" | "ref"
    dtype: str = "bfloat16"
    # Perf knobs (hillclimbing levers; defaults = paper-faithful baseline).
    seq_parallel: bool = False   # Megatron-SP style activation sharding
    fused_qkv: bool = True
    # Dry-run cost-extraction mode: python-loop the layer stack instead of
    # lax.scan so XLA cost analysis sees every layer (scan bodies are counted
    # once). Never used for real execution.
    unroll_layers: bool = False

    # -- derived helpers ---------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Analytic parameter count (matches init_params; used for 6ND)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def n_active_params(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    """A workload cell: sequence length x global batch x step kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.seq_len * self.global_batch


# The four assigned input shapes (identical across the LM family).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def scaled_shape(shape: ShapeConfig, batch_div: int = 1, seq_div: int = 1) -> ShapeConfig:
    """Reduced variant of a shape (smoke tests / scheduler job variants)."""

    return ShapeConfig(
        name=f"{shape.name}_d{batch_div}x{seq_div}",
        seq_len=max(8, shape.seq_len // seq_div),
        global_batch=max(1, shape.global_batch // batch_div),
        kind=shape.kind,
    )
