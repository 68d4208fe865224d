"""TP presets: the ``model``-axis extent and transport of a dense arch's
TP training run (the TP part of ``repro.configs.presets``).

``tp_transport="fused"`` pins the fused collective matmuls
(``kernels/cc_matmul``, hand-written CUDA kernels) at the QKV/up
all_gather and O/down reduce_scatter edges of every dense block.  The EP
presets of the reference come with expert parallelism (ROADMAP queue 1
item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class TPPreset:
    """One TP-enabled run recipe for a dense arch: the ``model``-axis
    extent and the transport the dense-block TP edges ride."""

    arch: str                 # registry name of the ModelConfig
    tp_axis: int              # recommended ``model`` axis extent
    tp_transport: str = "fused"   # TransportPolicy.tp

    @property
    def config(self) -> ModelConfig:
        from repro_torch.configs import get_config

        return get_config(self.arch)

    @property
    def step(self):
        """The port's ``StepConfig`` with the TP transport policy bound."""
        from repro_torch.dist.steps import StepConfig, TransportPolicy

        return StepConfig(transport=TransportPolicy(tp=self.tp_transport))


#: the reference's TP recipes, field for field.
TP_PRESETS: Dict[str, TPPreset] = {
    "nemotron-4-340b-tp": TPPreset(arch="nemotron-4-340b", tp_axis=8),
    "h2o-danube-1.8b-tp": TPPreset(arch="h2o-danube-1.8b", tp_axis=8),
}

TP_PRESET_NAMES: Tuple[str, ...] = tuple(TP_PRESETS)


def get_tp_preset(name: str) -> TPPreset:
    """Resolve a TP preset by name (``<arch>-tp``), validated against the
    arch's divisibility constraints (``models.artblock.supports_art_tp``)."""
    if name not in TP_PRESETS:
        raise KeyError(
            f"unknown TP preset {name!r}; known: {sorted(TP_PRESETS)}")
    p = TP_PRESETS[name]
    from repro_torch.models.artblock import supports_art_tp

    assert supports_art_tp(p.config, p.tp_axis), (name, p.tp_axis)
    return p


__all__ = ["TPPreset", "TP_PRESETS", "TP_PRESET_NAMES", "get_tp_preset"]
