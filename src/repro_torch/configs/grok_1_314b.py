"""grok-1-314b — MoE 8 experts top-2, GQA kv=8, GeGLU experts.

[hf:xai-org/grok-1; unverified]  316.5 B parameters: one card holds it at
``reduced()`` only; its full width needs its experts split over cards
(``models/moe_ep.py``), a host with more cards than one.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    head_dim=128,
    n_experts=8,
    experts_per_token=2,
    moe_layer_period=1,
    activation="gelu",
    gated_mlp=True,
)
