"""internvl2-2b — InternViT frontend (stub) + InternLM2-1.8B backbone.

[arXiv:2404.16821; hf]  Per task spec the ViT frontend is a STUB:
``input_specs()`` provides precomputed patch embeddings (frontend_tokens ×
frontend_dim) which a linear projector maps into the LM sequence.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    head_dim=128,
    activation="silu",
    gated_mlp=True,
    frontend="vit_stub",
    frontend_tokens=256,
    frontend_dim=1024,
)
