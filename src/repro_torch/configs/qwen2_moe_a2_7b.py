"""qwen2-moe-a2.7b — MoE: 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.configs.base import ModelConfig, MoECfg

FULL = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2_048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1_408,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoECfg(n_routed=60, top_k=4, n_shared=4, d_expert=1_408, every=1),
)

SMOKE = FULL.replace(
    name="qwen2-moe-a2.7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=96,
    vocab_size=256,
    moe=MoECfg(n_routed=6, top_k=2, n_shared=2, d_expert=96, every=1),
)
