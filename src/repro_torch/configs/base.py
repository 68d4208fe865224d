"""ModelConfig and the serving capability table (copy of ``repro.configs.base``).

The port keeps its own copy rather than importing the reference: ``import
repro`` installs the JAX compatibility shims and pulls in jax.  Field names,
defaults and ``reduced()`` are the reference's, so a config of either
package describes the same model (``tests/test_torch_configs.py`` holds the
two field for field).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default: d_model // n_heads

    # -- attention variant ---------------------------------------------------
    attn_type: str = "gqa"          # gqa | mla | none
    window: Optional[int] = None    # sliding-window attention (h2o-danube)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # -- MLP -------------------------------------------------------------------
    activation: str = "silu"        # silu | gelu | relu2
    gated_mlp: bool = True

    # -- MoE -------------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_layer_period: int = 1
    capacity_factor: float = 1.25

    # -- SSM (mamba2 / zamba2) --------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_stream_segments: int = 0
    hybrid_period: int = 0
    n_shared_blocks: int = 0

    # -- encoder-decoder (whisper) ----------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    decoder_max_seq: int = 448

    # -- modality frontend ------------------------------------------------------
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    frontend_dim: int = 0

    # -- common ------------------------------------------------------------------
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # -- numerics / implementation ------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # the reference's attention-impl knobs.  The port serves through the
    # flash kernel (its plain version on the CPU) and trains through
    # blockwise attention, which reads the chunks and the causal skip;
    # attn_impl is kept so configs compare field for field
    attn_impl: str = "auto"
    attn_q_chunk: int = 2048
    attn_kv_chunk: int = 2048
    causal_block_skip: bool = True
    remat: str = "full"

    # -- the paper's technique (TP collectives) --------------------------------------
    use_art: bool = True
    art_chunks: int = 4

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def reduced(self) -> "ModelConfig":
        """Same-family miniature for CPU tests (the reference's rule)."""
        r = {
            "n_layers": min(self.n_layers, 2),
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            "d_ff": 128,
            "vocab_size": 256,
            "head_dim": 16,
            "param_dtype": "float32",
            "compute_dtype": "float32",
            "attn_impl": "jnp",
            "attn_q_chunk": 16,
            "attn_kv_chunk": 16,
            "remat": "none",
        }
        if self.attn_type == "mla":
            r.update(q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8,
                     qk_nope_dim=8, v_head_dim=16, head_dim=16)
        if self.window is not None:
            r["window"] = 8
        if self.n_experts:
            r.update(n_experts=4, experts_per_token=min(self.experts_per_token, 2))
        if self.family in ("ssm", "hybrid"):
            r.update(ssm_state=16, ssm_heads=4, ssm_head_dim=16, ssm_chunk=8,
                     ssm_groups=1)
            if self.family == "hybrid":
                r.update(n_layers=5, hybrid_period=2,
                         n_shared_blocks=min(self.n_shared_blocks, 2))
        if self.family == "encdec":
            r.update(n_encoder_layers=2, encoder_seq=16, decoder_max_seq=32)
        if self.frontend:
            r.update(frontend_tokens=16 if self.family == "encdec" else 8,
                     frontend_dim=32)
        return dataclasses.replace(self, **r)


@dataclasses.dataclass(frozen=True)
class ChunkCarrySpec:
    """What one streamed-prefill chunk hands to the next (reference
    ``configs.base.ChunkCarrySpec``).  The ``ring`` (dense GQA), ``state``
    (Mamba-2) and ``hybrid`` (zamba2) kinds are ported so far."""

    kind: str              # ring | latent | state | hybrid | encdec
    constant_size: bool    # carry size independent of the prompt length
    exact: bool            # the reference's chunked ≡ bulk bit-identity claim
    chunk_multiple: int    # interior cuts land on multiples of this
    note: str = ""


def chunk_carry_spec(cfg: ModelConfig) -> ChunkCarrySpec:
    """The chunk-carry contract of ``cfg`` — total over the config zoo."""
    if cfg.family == "ssm":
        return ChunkCarrySpec(
            "state", constant_size=True, exact=True,
            chunk_multiple=max(1, cfg.ssm_chunk),
            note="constant SSD state + conv tail per layer")
    if cfg.family == "hybrid":
        return ChunkCarrySpec(
            "hybrid", constant_size=False, exact=True,
            chunk_multiple=max(1, cfg.ssm_chunk),
            note="SSD state pair + shared-attention ring rows")
    if cfg.family == "encdec":
        return ChunkCarrySpec(
            "encdec", constant_size=False, exact=True, chunk_multiple=1,
            note="cross-K/V once at chunk 0, decoder ring rows after")
    if cfg.attn_type == "mla":
        return ChunkCarrySpec(
            "latent", constant_size=False, exact=True, chunk_multiple=1,
            note="latent ckv + shared rope key rows")
    if cfg.family == "moe":
        return ChunkCarrySpec(
            "ring", constant_size=False, exact=False, chunk_multiple=1,
            note="chunk-local expert capacity — exact iff no row drops")
    return ChunkCarrySpec("ring", constant_size=False, exact=True,
                          chunk_multiple=1, note="K/V ring rows")


def serving_features(cfg: ModelConfig) -> "dict[str, bool]":
    """Arch × serving-feature support row (the reference's table)."""
    spec = chunk_carry_spec(cfg)
    paged = (cfg.family in ("dense", "vlm", "moe")
             and cfg.attn_type != "mla")
    return {
        "chunked": True,
        "chunked_exact": spec.exact,
        "paged": paged,
        "prefix_cache": (paged and cfg.window is None
                         and not cfg.frontend),
        "ep_decode": cfg.family == "moe",
    }
