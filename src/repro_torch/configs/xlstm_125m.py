"""xlstm-125m — sLSTM + mLSTM block stack (d_ff=0: FFN lives inside blocks).
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig, XLSTMCfg

FULL = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_head=192,
    d_ff=0,                    # no separate FFN: m/s blocks carry up-projections
    vocab_size=50_304,
    qkv_bias=False,
    rope_theta=0.0,            # recurrence provides position information
    xlstm=XLSTMCfg(pattern="ms", expand_m=2.0, proj_factor_s=4.0 / 3.0),
    sub_quadratic=True,
)

SMOKE = FULL.replace(
    name="xlstm-125m-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    vocab_size=256,
    xlstm=XLSTMCfg(pattern="ms", expand_m=2.0, proj_factor_s=4.0 / 3.0, chunk=16),
)
