"""Run presets: the ``expert``-axis extent and transport of a MoE arch's
expert-parallel run, and the ``model``-axis extent and transport of a
dense arch's TP training run (``repro.configs.presets``, field for
field).

An EP preset pairs a MoE arch with a ``StepConfig`` whose
``TransportPolicy.moe`` routes the expert dispatch through the conduit
``all_to_all`` (``models/moe_ep.py``) in ``stream_chunks`` ART chunks,
and the expert-axis extent its group should have.  The reference's
presets name ``moe_transport="auto"``, whose pricing is not ported: a
step built from a preset's own policy raises naming ``ROADMAP_AUTO``, and
a run names ``ring`` or ``xla`` in its place (the reference holds
``auto`` ≡ ``xla`` ≡ ``ring`` in value)::

    preset = get_ep_preset("grok-1-314b-ep")
    step = dataclasses.replace(preset.step, transport=TransportPolicy(
        moe="ring", moe_stream_chunks=preset.stream_chunks))

``tp_transport="fused"`` pins the fused collective matmuls
(``kernels/cc_matmul``, hand-written CUDA kernels) at the QKV/up
all_gather and O/down reduce_scatter edges of every dense block.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class EPPreset:
    """One EP run recipe: the arch, the ``expert`` axis extent, the MoE
    transport and the ART chunks of each EP exchange (1: bulk; the
    streamed dispatch is bit-identical to bulk)."""

    arch: str                 # registry name of the ModelConfig
    expert_axis: int          # recommended ``expert`` axis extent
    moe_transport: str = "auto"   # TransportPolicy.moe
    stream_chunks: int = 4    # ART chunks a EP exchange (1: bulk)

    @property
    def config(self) -> ModelConfig:
        from repro_torch.configs import get_config

        return get_config(self.arch)

    @property
    def step(self):
        """The port's ``StepConfig`` with the EP transport policy bound."""
        from repro_torch.dist.steps import StepConfig, TransportPolicy

        return StepConfig(
            transport=TransportPolicy(moe=self.moe_transport,
                                      moe_stream_chunks=self.stream_chunks))


#: the reference's EP recipes, field for field: ``expert_axis`` is the
#: largest power of two dividing ``n_experts`` that leaves ≥ 2 experts a
#: shard.
EP_PRESETS: Dict[str, EPPreset] = {
    "llama4-scout-17b-a16e-ep": EPPreset(
        arch="llama4-scout-17b-a16e", expert_axis=8),
    "grok-1-314b-ep": EPPreset(arch="grok-1-314b", expert_axis=4),
}

EP_PRESET_NAMES: Tuple[str, ...] = tuple(EP_PRESETS)


def get_ep_preset(name: str) -> EPPreset:
    """Resolve an EP preset by name (``<arch>-ep``), validated against the
    arch it points at: a MoE arch whose experts split over the axis, ≥ 2
    a shard."""
    if name not in EP_PRESETS:
        raise KeyError(
            f"unknown EP preset {name!r}; known: {sorted(EP_PRESETS)}")
    p = EP_PRESETS[name]
    cfg = p.config
    assert cfg.family == "moe", (name, cfg.family)
    assert cfg.n_experts % p.expert_axis == 0, (
        name, cfg.n_experts, p.expert_axis)
    assert cfg.n_experts // p.expert_axis >= 2, (name, p.expert_axis)
    return p


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


__all__ = ["EPPreset", "EP_PRESETS", "EP_PRESET_NAMES", "get_ep_preset",
           "TPPreset", "TP_PRESETS", "TP_PRESET_NAMES", "get_tp_preset"]
