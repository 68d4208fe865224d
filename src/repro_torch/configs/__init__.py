"""Architecture registry of the port: ``--arch <id>`` resolves here.

Every arch of the reference: the dense GQA archs (smollm, h2o-danube and
nemotron, the last held at ``reduced()``), the dense MLA arch minicpm3
(multi-head latent attention), the pure-SSM mamba2, the zamba2 hybrid (a
Mamba-2 backbone with shared attention blocks), the internvl2 VLM (patch
embeddings before the text), the whisper encoder-decoder, and the MoE
archs llama4-scout (served with its depth cut) and grok-1 (held at
``reduced()``).
"""

from __future__ import annotations

from repro_torch.configs.base import (
    ChunkCarrySpec,
    ModelConfig,
    chunk_carry_spec,
    serving_features,
)
from repro_torch.configs.grok_1_314b import config as _grok1
from repro_torch.configs.h2o_danube_1p8b import config as _h2o_danube
from repro_torch.configs.internvl2_2b import config as _internvl2
from repro_torch.configs.llama4_scout_17b_a16e import config as _llama4
from repro_torch.configs.mamba2_2p7b import config as _mamba2
from repro_torch.configs.minicpm3_4b import config as _minicpm3
from repro_torch.configs.nemotron_4_340b import config as _nemotron
from repro_torch.configs.smollm_360m import config as _smollm
from repro_torch.configs.whisper_tiny import config as _whisper
from repro_torch.configs.zamba2_7b import config as _zamba2

_CONFIGS = {c.name: c for c in (_smollm, _h2o_danube, _mamba2, _zamba2,
                                _internvl2, _whisper, _nemotron,
                                _minicpm3, _llama4, _grok1)}

ARCH_NAMES = tuple(_CONFIGS)


def get_config(name: str) -> ModelConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_CONFIGS)}")
    return _CONFIGS[name]


# imported after get_config exists: a preset resolves its arch through it
from repro_torch.configs.presets import (  # noqa: E402
    EP_PRESET_NAMES,
    EP_PRESETS,
    TP_PRESET_NAMES,
    TP_PRESETS,
    EPPreset,
    TPPreset,
    get_ep_preset,
    get_tp_preset,
)

__all__ = ["ARCH_NAMES", "ChunkCarrySpec", "EPPreset", "EP_PRESETS",
           "EP_PRESET_NAMES", "ModelConfig", "TPPreset", "TP_PRESETS",
           "TP_PRESET_NAMES", "chunk_carry_spec", "get_config",
           "get_ep_preset", "get_tp_preset", "serving_features"]
