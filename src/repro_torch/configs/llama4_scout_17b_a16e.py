"""llama4-scout-17b-a16e — MoE 16 routed experts (top-1) + 1 shared, GQA kv=8.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  Early-fusion MoE: every
layer is MoE (period 1).  The assigned config specifies full attention, so
long_500k is skipped (DESIGN §5) — Llama-4's chunked-attention variants are
not part of the assigned cell.  107.8 B parameters at 48 layers: one card
serves it only with its depth cut (``dataclasses.replace(cfg,
n_layers=8)``, 19.69 B), every width kept.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    n_experts=16,
    experts_per_token=1,
    n_shared_experts=1,
    moe_layer_period=1,
    activation="silu",
    gated_mlp=True,
    rope_theta=500_000.0,
)
