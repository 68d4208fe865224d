"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818]  The dense GQA arch that exercises the window: the
4096-token window caps the K/V ring buffer.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32_000,
    head_dim=80,
    window=4096,
    activation="silu",
    gated_mlp=True,
)
