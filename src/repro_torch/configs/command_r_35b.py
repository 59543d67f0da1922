"""command-r-35b — dense GQA decoder, no-bias, 256k vocab.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8_192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22_528,
    vocab_size=256_000,
    qkv_bias=False,
    tie_embeddings=True,   # command-r ties input/output embeddings
    rope_theta=8_000_000.0,
)

SMOKE = FULL.replace(
    name="command-r-35b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
)
