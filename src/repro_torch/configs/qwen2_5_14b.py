"""qwen2.5-14b — dense GQA decoder with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5_120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=13_824,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = FULL.replace(
    name="qwen2.5-14b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
)
