"""jamba-v0.1-52b — hybrid Mamba+attention (1:7 interleave), MoE 16e top-2.
[arXiv:2403.19887; hf]

Structure per the Jamba paper: blocks of 8 layers with one attention layer at
block offset 4 (attn:mamba = 1:7); MoE replaces the dense MLP every 2nd layer.
"""
from repro_torch.configs.base import MambaCfg, ModelConfig, MoECfg

FULL = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14_336,
    vocab_size=65_536,
    qkv_bias=False,
    rope_theta=0.0,            # Jamba uses no positional encoding (Mamba provides it)
    moe=MoECfg(n_routed=16, top_k=2, n_shared=0, d_expert=14_336, every=2),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    attn_every=8,
    sub_quadratic=True,        # decode state is O(1)/token for 7/8 of layers
)

SMOKE = FULL.replace(
    name="jamba-v0.1-52b-smoke",
    n_layers=8,                # one full jamba super-block
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    moe=MoECfg(n_routed=4, top_k=2, n_shared=0, d_expert=128, every=2),
    mamba=MambaCfg(d_state=8, d_conv=4, expand=2, chunk=16),
    attn_every=8,
)
