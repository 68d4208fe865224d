"""The port's checkpoints and Trainer against the reference's.

* checkpoints: a round trip is bit-exact for bf16, fp32 and int leaves
  and Python numbers; a directory written by the reference's
  ``save_checkpoint`` reads in the port with the same bits and manifest,
  and one the port writes reads in the reference; ``keep_last`` GC; an
  uncommitted ``.tmp`` directory is never read; a shape that does not
  match the template raises;
* the Trainer: a stop and a restart give the uninterrupted run's losses,
  grad norms and parameters bit for bit (the CPU step is deterministic);
  the watchdog strikes on the reference's rule (the same answers for the
  same step times, and inside ``train`` on a fake clock); SIGTERM leads
  to a checkpoint at the next step boundary and then the exit; the
  elastic paths raise (ROADMAP item 8).
"""

import json
import os
import signal

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.dist.steps import StepConfig as RefStepConfig
from repro.runtime.trainer import Trainer as RefTrainer
from repro.runtime.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.checkpoint import (
    CheckpointManager,
    list_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import sharding
from repro_torch.dist.steps import StepConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(4, 6, generator=g).to(torch.bfloat16),
                   "b": torch.randn(6, generator=g)},
        "layers": [torch.randint(-5, 5, (3,), generator=g,
                                 dtype=torch.int32),
                   torch.randn(2, 2, generator=g, dtype=torch.float64)],
        "step": 7,
    }


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_same(a, b):
    for (pa, x), (pb, y) in zip(sharding.leaves(a), sharding.leaves(b)):
        assert pa == pb
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, pa
            assert torch.equal(_bits(x), _bits(y)), pa
        else:
            assert type(x) is type(y) and x == y, pa


def test_round_trip_is_bit_exact(tmp_path):
    tree = _tree()
    tree["params"]["w"][0, 0] = float("nan")        # bits, not values
    path = save_checkpoint(str(tmp_path), 3, tree, extra={"loss": 1.5})
    assert os.path.basename(path) == "step_00000003"
    assert os.readlink(tmp_path / "latest") == "step_00000003"
    back, manifest = load_checkpoint(str(tmp_path), _tree(seed=1))
    _assert_same(back, tree)
    assert manifest["step"] == 3 and manifest["extra"] == {"loss": 1.5}
    names = [e["name"] for e in manifest["leaves"]]
    assert names == ["layers/0", "layers/1", "params/b", "params/w", "step"]
    assert [e["dtype"] for e in manifest["leaves"]] == [
        "int32", "float64", "float32", "bfloat16", "int64"]
    w = np.load(tmp_path / "step_00000003" / manifest["leaves"][3]["file"])
    assert w.dtype == np.uint16


def test_restore_places_leaves_on_the_callers_device(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    back, _ = load_checkpoint(str(tmp_path), _tree())
    assert back["params"]["w"].device.type == "cpu"
    back, _ = load_checkpoint(str(tmp_path), _tree(), device="meta")
    assert back["params"]["b"].device.type == "meta"
    assert back["params"]["b"].shape == (6,) and back["step"] == 7


def _ref_tree():
    rng = np.random.default_rng(5)
    return {"params": {"w": rng.standard_normal((4, 6)).astype(
                ml_dtypes.bfloat16),
            "b": rng.standard_normal(6).astype(np.float32)},
            "layers": [np.arange(3, dtype=np.int32),
                       rng.standard_normal((2, 2))],
            "step": jnp.asarray(9, jnp.int32)}


def test_reference_checkpoint_reads_bit_for_bit(tmp_path):
    ref = _ref_tree()
    ref_ckpt.save_checkpoint(str(tmp_path), 12, ref, extra={"loss": 2.0})
    template = _tree()
    template["step"] = torch.zeros((), dtype=torch.int32)
    back, manifest = load_checkpoint(str(tmp_path), template)
    with open(tmp_path / "step_00000012" / "manifest.json") as f:
        assert manifest == json.load(f)
    assert back["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back["params"]["w"].view(torch.int16).numpy().view(np.uint16),
        ref["params"]["w"].view(np.uint16))
    np.testing.assert_array_equal(back["params"]["b"].numpy(),
                                  ref["params"]["b"])
    np.testing.assert_array_equal(back["layers"][0].numpy(),
                                  ref["layers"][0])
    np.testing.assert_array_equal(back["layers"][1].numpy(),
                                  ref["layers"][1])
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 9


def test_port_checkpoint_reads_in_the_reference(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 4, tree)
    ref_template = _ref_tree()
    back, manifest = ref_ckpt.load_checkpoint(str(tmp_path), ref_template)
    assert manifest["step"] == 4
    np.testing.assert_array_equal(
        np.asarray(back["params"]["w"]).view(np.uint16),
        tree["params"]["w"].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(np.asarray(back["params"]["b"]),
                                  tree["params"]["b"].numpy())
    assert int(back["step"]) == 7


def test_keep_last_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), interval=2, keep_last=2)
    assert [mgr.should_save(s) for s in range(5)] == [False, False, True,
                                                      False, True]
    for step in (2, 4, 6, 8):
        mgr.save(step, _tree(step))
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [6, 8]
    assert mgr.latest_step() == 8
    back, manifest = mgr.restore_or_none(_tree())
    assert manifest["step"] == 8
    _assert_same(back, _tree(8))
    assert CheckpointManager(str(tmp_path / "none")).restore_or_none(
        _tree()) is None


def test_uncommitted_tmp_is_never_read(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(1))
    save_checkpoint(str(tmp_path), 2, _tree(2))
    # a crash mid-write of step 3: everything but the rename
    os.rename(tmp_path / "step_00000002", tmp_path / "step_00000003.tmp")
    assert [s for s, _ in list_checkpoints(str(tmp_path))] == [1]
    back, manifest = load_checkpoint(str(tmp_path), _tree())
    assert manifest["step"] == 1
    _assert_same(back, _tree(1))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), _tree(), step=3)
    # a rewrite of step 3 replaces the stale .tmp
    save_checkpoint(str(tmp_path), 3, _tree(3))
    assert not (tmp_path / "step_00000003.tmp").exists()
    _assert_same(load_checkpoint(str(tmp_path), _tree())[0], _tree(3))


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["params"]["b"] = torch.zeros(7)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path), bad)
    extra = _tree()
    extra["params"]["c"] = torch.zeros(1)
    with pytest.raises(KeyError, match="params/c"):
        load_checkpoint(str(tmp_path), extra)


def test_restore_into_refuses_another_dtype(tmp_path):
    """A copy into the template's tensor keeps the stored bits: a stored
    bf16 leaf into an fp32 template raises instead of converting."""
    save_checkpoint(str(tmp_path), 1, _tree())
    into = _tree(1)
    back, _ = load_checkpoint(str(tmp_path), into, into=True)
    assert back["params"]["w"] is into["params"]["w"]
    _assert_same(back, _tree())
    bad = _tree()
    bad["params"]["w"] = bad["params"]["w"].float()
    with pytest.raises(ValueError, match="params/w.*dtype"):
        load_checkpoint(str(tmp_path), bad, into=True)


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------


def _trainer(ckpt_dir, total, interval=100, **kw):
    """A trainer that stops at ``total`` of a 6-step schedule."""
    cfg = get_config("smollm-360m").reduced()
    scfg = StepConfig(microbatches=2, seq_chunk=8, warmup_steps=2,
                      total_steps=6, peak_lr=1e-3)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=17,
                                  global_batch=4))
    tcfg = TrainerConfig(total_steps=total, ckpt_dir=str(ckpt_dir),
                         ckpt_interval=interval, log_interval=100)
    return Trainer(cfg, scfg, tcfg, data, device="cpu",
                   log_fn=kw.pop("log_fn", lambda s: None), **kw)


def test_restart_gives_the_uninterrupted_trajectory(tmp_path):
    full = _trainer(tmp_path / "a", total=6)
    p_full, o_full, step = full.train()
    assert step == 6 and len(full.history) == 6

    first = _trainer(tmp_path / "b", total=4, interval=2)
    first.train()
    logs = []
    resumed = _trainer(tmp_path / "b", total=6, log_fn=logs.append)
    p_res, o_res, step = resumed.train()
    assert step == 6 and [h["step"] for h in resumed.history] == [5, 6]
    assert any("restored step 4" in line for line in logs)
    for key in ("loss", "grad_norm", "lr", "ce"):
        assert [h[key] for h in first.history + resumed.history] == \
            [h[key] for h in full.history], key
    _assert_same((p_res, o_res), (p_full, o_full))


def test_watchdog_follows_the_reference_rule(tmp_path):
    cfg = ref_get_config("smollm-360m").reduced()
    ref = RefTrainer(cfg, RefStepConfig(), RefTrainerConfig(
        ckpt_dir=str(tmp_path / "r")), RefSyntheticLM(RefDataConfig(
            vocab_size=cfg.vocab_size, seq_len=17, global_batch=4)),
        log_fn=lambda s: None)
    ours = _trainer(tmp_path / "p", total=1)
    times = [0.1] * 10 + [1.0, 1.0, 1.0, 0.1, 1.0, 0.1, 0.31, 0.29, 5.0,
                          5.0, 5.0, 5.0] + [0.2] * 3
    for dt in times:
        assert ours._watch_step_time(dt) == ref._watch_step_time(dt), dt
        assert ours._straggler_strikes == ref._straggler_strikes


def test_watchdog_fires_inside_train_on_a_fake_clock(tmp_path):
    """Steps 1–5 take 1 s on the clock, 6–8 take 10 s: three strikes in
    a row exhaust the budget at step 8, and the strikes reset."""
    ticks = []
    for k in range(8):
        ticks += [100.0 * k, 100.0 * k + (10.0 if k >= 5 else 1.0)]
    clock = iter(ticks).__next__
    logs = []
    t = _trainer(tmp_path, total=8, clock=clock, log_fn=logs.append)
    t.train()
    assert [h["step_time_s"] for h in t.history] == [1.0] * 5 + [10.0] * 3
    strikes = [line for line in logs if line.startswith("[watchdog] slow")]
    assert [s.split("strike ")[1] for s in strikes] == ["1)", "2)", "3)"]
    assert any("budget exhausted" in line for line in logs)
    assert t._straggler_strikes == 0


def test_sigterm_checkpoints_at_the_next_boundary_and_exits(tmp_path):
    t = _trainer(tmp_path, total=50)
    previous = t.install_signal_handler()
    seen = []
    try:
        def on_step(step, m):
            seen.append(step)
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        params, opt, step = t.train(on_step=on_step)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert step == 2 and seen == [1, 2]
    assert t.ckpt.latest_step() == 2
    back, manifest = load_checkpoint(str(tmp_path), (params, opt))
    assert manifest["extra"]["loss"] == t.history[-1]["loss"]
    _assert_same(back, (params, opt))


def test_elastic_paths_raise_item_8(tmp_path):
    t = _trainer(tmp_path, total=1)
    for fn in (t._recover_mesh, t._scale_out):
        with pytest.raises(NotImplementedError, match="item 8"):
            fn()
