"""seamless-m4t-large-v2 — encoder-decoder multimodal (audio) backbone.
[arXiv:2308.11596; hf]

The speech frontend (w2v-BERT feature extractor) is a STUB: ``input_specs``
provides precomputed frame embeddings of shape (batch, enc_len, d_model).
24 encoder + 24 decoder layers (the assigned 24L is interpreted per side,
matching the seamless large text-decoder depth).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,               # decoder layers
    n_enc_layers=24,           # encoder layers
    d_model=1_024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8_192,
    vocab_size=256_206,
    qkv_bias=True,
    enc_dec=True,
    enc_len=4_096,             # encoder frames for decode shapes (speech ~ downsampled)
    rope_theta=10_000.0,
)

SMOKE = FULL.replace(
    name="seamless-m4t-large-v2-smoke",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    enc_len=16,
)
