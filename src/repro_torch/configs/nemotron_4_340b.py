"""nemotron-4-340b — dense GQA kv=8, squared-ReLU MLP (not gated).

[arXiv:2402.16819; unverified]  The biggest assigned arch: 340B params.
Fits the 256-chip pod only under full FSDP×TP sharding with sequence-
parallel activations and bf16 optimizer moments (see EXPERIMENTS §Dry-run).
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73_728,
    vocab_size=256_000,
    head_dim=192,
    activation="relu2",
    gated_mlp=False,
)
