"""whisper-tiny — encoder-decoder audio backbone; conv frontend is a STUB.

[arXiv:2212.04356; unverified]  Per task spec ``input_specs()`` provides
precomputed frame embeddings (1500 × 384) for the encoder; the decoder is a
standard causal transformer with cross-attention.  long_500k skipped
(decoder context 448).  Uses LayerNorm and sinusoidal/learned positions
rather than RMSNorm+RoPE.
"""
from repro_torch.configs.base import ModelConfig

config = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    head_dim=64,
    n_encoder_layers=4,
    encoder_seq=1500,
    decoder_max_seq=448,
    activation="gelu",
    gated_mlp=False,
    frontend="audio_stub",
    frontend_tokens=1500,
    frontend_dim=384,
    tie_embeddings=True,
)
