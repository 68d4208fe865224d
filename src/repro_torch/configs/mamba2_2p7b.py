"""mamba2-2.7b — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060]  d_inner = 2·2560 = 5120, 80 heads × 64 head-dim,
d_state 128, 1 B/C group, conv4.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    attn_type="none",
    ssm_state=128,
    ssm_heads=80,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=True,
)
