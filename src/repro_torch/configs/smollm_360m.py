"""smollm-360m — small llama-architecture LM (the port's main path).

[hf:HuggingFaceTB/SmolLM-360M]
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49_152,
    head_dim=64,
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
)
