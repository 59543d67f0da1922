"""llama3-8b — dense GQA decoder, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14_336,
    vocab_size=128_256,
    qkv_bias=False,
    rope_theta=500_000.0,
)

SMOKE = FULL.replace(
    name="llama3-8b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
)
