"""The port's configs, import boundary and device policy.

* every config field equals the reference's, full and ``reduced()``;
* ``repro_torch`` imports neither jax nor anything of ``repro``;
* entry points default to the GPU and raise when there is none.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.configs import get_config as ref_get_config
from repro_torch.configs import ARCH_NAMES, base, get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["smollm-360m", "h2o-danube-1.8b",
                                  "mamba2-2.7b", "zamba2-7b",
                                  "internvl2-2b", "whisper-tiny",
                                  "nemotron-4-340b", "minicpm3-4b",
                                  "llama4-scout-17b-a16e", "grok-1-314b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_equal_reference(name, reduced):
    ours, ref = get_config(name), ref_get_config(name)
    if reduced:
        ours, ref = ours.reduced(), ref.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    if ref.head_dim or ref.n_heads:     # attention-free archs have none
        assert ours.resolved_head_dim == ref.resolved_head_dim
    assert dataclasses.asdict(base.chunk_carry_spec(ours)) == \
        dataclasses.asdict(ref_base.chunk_carry_spec(ref))
    assert base.serving_features(ours) == ref_base.serving_features(ref)


def test_registry_names_and_unknown_arch():
    """The port registers the reference's ten archs, and a name neither
    package registers raises."""
    from repro.configs import ARCH_NAMES as REF_ARCH_NAMES

    assert set(ARCH_NAMES) == {"smollm-360m", "h2o-danube-1.8b",
                               "mamba2-2.7b", "zamba2-7b", "internvl2-2b",
                               "whisper-tiny", "nemotron-4-340b",
                               "minicpm3-4b", "llama4-scout-17b-a16e",
                               "grok-1-314b"}
    assert set(ARCH_NAMES) == set(REF_ARCH_NAMES)
    with pytest.raises(KeyError):
        get_config("gpt-2-124m")


def test_package_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules\n"
        "                 if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 15, out.stdout


class TestDevicePolicy:
    """With no GPU, entry points raise unless the caller asks for the CPU."""

    @pytest.fixture(autouse=True)
    def _no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_init_params_raises_without_device(self):
        from repro_torch.models.model import init_params

        cfg = get_config("smollm-360m").reduced()
        with pytest.raises(RuntimeError, match="CUDA"):
            init_params(cfg, seed=0)
        params = init_params(cfg, seed=0, device="cpu")
        assert params["embed"].device.type == "cpu"

    def test_server_raises_without_device(self):
        from repro_torch.models.model import init_params
        from repro_torch.runtime.server import Server

        cfg = get_config("smollm-360m").reduced()
        params = init_params(cfg, seed=0, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            Server(cfg, params)
        assert Server(cfg, params, device="cpu").device.type == "cpu"

    def test_launcher_raises_without_device(self):
        from repro_torch.launch import serve

        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--requests", "1"])

    def test_tp_group_raises_without_device(self):
        from repro_torch.dist.group import RankPool, init_group

        with pytest.raises(RuntimeError, match="CUDA"):
            RankPool(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_group(0, 1, "/nonexistent/rendezvous")

    def test_kernel_wrapper_rejects_other_devices(self):
        from repro_torch.kernels.flash_attention import FLASH, flash_attention

        q = torch.zeros(1, 2, 4, 16, device="meta")
        before = FLASH.launches
        with pytest.raises(ValueError, match="device"):
            flash_attention(q, q, q)
        x = torch.from_numpy(
            np.random.default_rng(0).standard_normal((1, 2, 4, 16),
                                                     dtype=np.float32))
        flash_attention(x, x, x)         # CPU: the plain version
        assert FLASH.launches == before


def test_tp_presets_equal_reference():
    from repro.configs import TP_PRESETS as REF_TP_PRESETS
    from repro.configs import get_tp_preset as ref_get_tp_preset
    from repro_torch.configs.presets import TP_PRESETS, get_tp_preset
    from repro_torch.dist.steps import StepConfig

    assert list(TP_PRESETS) == list(REF_TP_PRESETS)
    for name, preset in TP_PRESETS.items():
        assert dataclasses.asdict(preset) == \
            dataclasses.asdict(REF_TP_PRESETS[name])
    ours, ref = get_tp_preset("h2o-danube-1.8b-tp"), \
        ref_get_tp_preset("h2o-danube-1.8b-tp")
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(ref.config)
    assert isinstance(ours.step, StepConfig)
    assert ours.step.transport.tp == ref.step.transport.tp == "fused"
    ours, ref = get_tp_preset("nemotron-4-340b-tp"), \
        ref_get_tp_preset("nemotron-4-340b-tp")
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(ref.config)
    assert (ours.tp_axis, ours.step.transport.tp) == (8, "fused")
    with pytest.raises(KeyError):
        get_tp_preset("smollm-360m-tp")


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8, 16])
def test_supports_art_tp_equals_reference(tp):
    from repro.models.artblock import supports_art_tp as ref_supports
    from repro_torch.models.artblock import supports_art_tp

    for name in ARCH_NAMES:
        for reduced in (False, True):
            ours, ref = get_config(name), ref_get_config(name)
            if reduced:
                ours, ref = ours.reduced(), ref.reduced()
            assert supports_art_tp(ours, tp) == ref_supports(ref, tp)
