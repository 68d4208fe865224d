"""zamba2-7b — hybrid: Mamba2 backbone + 2 alternating *shared* attention
blocks applied every 6 SSM layers.

[arXiv:2411.15242; unverified]  The shared blocks reuse one parameter set
across applications (depth-sharing), so the attention params are counted
once but executed ~13 times.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    head_dim=112,
    ssm_state=64,
    ssm_heads=112,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_expand=2,
    hybrid_period=6,
    n_shared_blocks=2,
    activation="gelu",
    gated_mlp=True,
    # keep the products with no batch dimension, recompute the rest
    # (models/model.py::_maybe_remat); reduced() sets remat="none"
    remat="dots",
)
