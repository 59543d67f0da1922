"""mistral-nemo-12b — dense GQA decoder, 128k context, head_dim 128 (< d_model/H).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5_120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,          # explicit head_dim (not d_model // n_heads = 160)
    d_ff=14_336,
    vocab_size=131_072,
    qkv_bias=False,
    rope_theta=1_000_000.0,
)

SMOKE = FULL.replace(
    name="mistral-nemo-12b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=8,            # keep the d_head != d_model//n_heads property
    d_ff=128,
    vocab_size=256,
)
