"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6.
[arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ModelConfig, MoECfg

FULL = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2_048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1_408,              # fine-grained expert hidden size
    vocab_size=102_400,
    qkv_bias=False,
    rope_theta=10_000.0,
    moe=MoECfg(n_routed=64, top_k=6, n_shared=2, d_expert=1_408, every=1),
)

SMOKE = FULL.replace(
    name="deepseek-moe-16b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=96,
    vocab_size=256,
    moe=MoECfg(n_routed=8, top_k=2, n_shared=2, d_expert=96, every=1),
)
