"""minicpm3-4b — dense with Multi-head Latent Attention (MLA).

[hf:openbmb/MiniCPM3-4B; hf]  MLA compresses K/V into a 256-dim latent
(+32-dim shared rope key), so a decode cache holds 288 values a token and
layer instead of 40 heads × (96 + 64).  Attention runs at q/k head dim 96
(64 latent-expanded + 32 rope) and v head dim 64.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73_448,
    attn_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_rope_dim=32,
    qk_nope_dim=64,
    v_head_dim=64,
    head_dim=96,           # qk_nope + qk_rope
    activation="silu",
    gated_mlp=True,
)
