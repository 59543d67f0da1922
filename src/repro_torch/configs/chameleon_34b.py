"""chameleon-34b — early-fusion VLM backbone; VQ image tokens share the vocab.
[arXiv:2405.09818; unverified]

The modality frontend (VQ-GAN tokenizer) is a STUB: ``input_specs`` provides
token ids that already include the image-token id range. The backbone is a
dense GQA decoder (Chameleon uses QK-norm for stability; modeled here).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8_192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22_016,
    vocab_size=65_536,
    qkv_bias=False,
    rope_theta=10_000.0,
)

SMOKE = FULL.replace(
    name="chameleon-34b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
)
