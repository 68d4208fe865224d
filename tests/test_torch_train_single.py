"""The port's one-device training against the reference's.

* ``models.model.loss_fn`` against ``repro.models.model.loss_fn``: the
  total, the metrics and every parameter's gradient at 1e-5;
* the tp-1 ``build_train_step`` against the reference's on a one-device
  mesh: 3 steps of reduced ``smollm-360m``, ``h2o-danube-1.8b``,
  ``mamba2-2.7b`` (its SSD scan through the scan's autograd Function) and
  ``zamba2-7b`` (the hybrid: its shared blocks' gradients summed over
  their applications) in fp32, with microbatches 1 and 2, fed the
  reference's parameters (through ``repro_torch.bridge``) and the
  reference's ``SyntheticLM`` batches: loss, grad norm and lr of every
  step at 1e-5 relative, and every parameter leaf after the last step at
  rtol = atol = 1e-5;
* microbatch accumulation: 4 microbatches give the full-batch update (the
  reference's own check, ``tests/test_dist.py``, at its tolerances), and
  bucketed accumulation gives the bits of leaf-by-leaf accumulation;
* ``dist.bucketing`` against ``repro.dist.bucketing``;
* the training forward never reaches the flash kernel's wrapper, the
  ssm family raises at tp ≥ 2 (ART-TP is dense-only), and the launcher
  and the example run on the CPU (smollm and mamba2; the launcher also
  reduced zamba2, and refuses full-width zamba2 at its published depth on
  memory).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.data.pipeline import batch_specs
from repro.dist import bucketing as ref_bucketing
from repro.dist.steps import StepConfig as RefStepConfig
from repro.dist.steps import build_init as ref_build_init
from repro.dist.steps import build_train_step as ref_build_train_step
from repro.launch.mesh import make_host_mesh
from repro.models import model as ref_model
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import bucketing, sharding, steps
from repro_torch.dist.group import Group
from repro_torch.dist.steps import (
    StepConfig,
    build_init,
    build_train_step,
    init_opt,
)
from repro_torch.kernels.common import refuse_autograd
from repro_torch.models import layers, model

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["smollm-360m", "h2o-danube-1.8b", "mamba2-2.7b", "zamba2-7b"]
STEP_KW = dict(seq_chunk=8, warmup_steps=1)
CPU = Group(rank=0, size=1, device=torch.device("cpu"))


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a), jax.device_get(tree))


def _batch(b):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in b.items()}


# ---------------------------------------------------------------------------
# loss_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(arch):
    cfg = ref_get_config(arch).reduced()
    ref_params = ref_model.init_params(cfg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 12))
    labels = rng.integers(0, cfg.vocab_size, size=(2, 12))
    labels[1, :5] = -1                                  # masked positions
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(cfg, p, batch), has_aux=True))(ref_params)

    params = params_from_reference(_tree_np(ref_params))
    for _, t in sharding.leaves(params):
        t.requires_grad_(True)
    got, got_m = model.loss_fn(
        get_config(arch).reduced(), params,
        {"tokens": torch.from_numpy(tokens),
         "labels": torch.from_numpy(labels)})
    got.backward()
    np.testing.assert_allclose(got.item(), float(total), **TOL)
    assert set(got_m) == set(metrics) == {"ce", "z_loss", "moe_aux",
                                          "tokens"}
    for k in metrics:
        np.testing.assert_allclose(got_m[k].item(), float(metrics[k]), **TOL)
    want = params_from_reference(_tree_np(grads))
    for (path, g), (_, w) in zip(sharding.leaves(params),
                                 sharding.leaves(want)):
        np.testing.assert_allclose(g.grad.numpy(), w.numpy(), **TOL,
                                   err_msg=str(path))


# ---------------------------------------------------------------------------
# the tp-1 step against the reference's one-device step
# ---------------------------------------------------------------------------

_REF = {}


def _reference(arch, micro):
    """The reference's 3 steps on a one-device mesh: initial params,
    batches, per-step (loss, grad_norm, lr) and the final params."""
    key = (arch, micro)
    if key not in _REF:
        cfg = ref_get_config(arch).reduced()
        mesh = make_host_mesh(data=1, model=1)
        scfg = RefStepConfig(microbatches=micro, **STEP_KW)
        data = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=17, global_batch=4))
        bundle = ref_build_train_step(cfg, mesh, scfg,
                                      batch_specs(16, 4, cfg.vocab_size))
        params, opt = ref_build_init(cfg, mesh, scfg)[0](
            jax.random.PRNGKey(0))
        params0 = _tree_np(params)
        batches, metrics = [], []
        for step in range(3):
            batch = data.global_batch(step)
            batches.append({k: np.asarray(v) for k, v in batch.items()})
            params, opt, m = bundle.fn(params, opt, batch, jnp.int32(step))
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            float(m["lr"])))
        _REF[key] = dict(params0=params0, batches=batches, metrics=metrics,
                         params=_tree_np(params))
    return _REF[key]


def _port_run(arch, ref, **step_kw):
    cfg = get_config(arch).reduced()
    scfg = StepConfig(**dict(STEP_KW, **step_kw))
    params = params_from_reference(ref["params0"])
    opt = init_opt(params, scfg)
    step_fn = build_train_step(cfg, CPU, scfg)
    metrics = []
    for k, b in enumerate(ref["batches"]):
        params, opt, m = step_fn(params, opt, _batch(b), k)
        metrics.append(m)
    return params, opt, metrics


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp1_step_matches_reference(arch, micro):
    ref = _reference(arch, micro)
    params, _, metrics = _port_run(arch, ref, microbatches=micro)
    got = [(m["loss"], m["grad_norm"], m["lr"]) for m in metrics]
    np.testing.assert_allclose(got, ref["metrics"], rtol=1e-5, atol=0)
    assert all(m["tokens"] == 4 * 16 for m in metrics)
    want = dict(sharding.leaves(params_from_reference(ref["params"])))
    for path, t in sharding.leaves(params):
        np.testing.assert_allclose(t.numpy(), want[path].numpy(), **TOL,
                                   err_msg=str(path))


def test_microbatches_equal_the_full_batch_update():
    """m = 1 and m = 4 give the same update (the reference's
    ``test_microbatch_equivalence``, at its tolerances)."""
    cfg = get_config("smollm-360m").reduced()
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=17,
                                   global_batch=8)).global_batch(0)
    outs = []
    for m in (1, 4):
        scfg = StepConfig(microbatches=m, seq_chunk=8, warmup_steps=2,
                          peak_lr=1e-3)
        params, opt = build_init(cfg, CPU, scfg)(0)
        params, _, met = build_train_step(cfg, CPU, scfg)(params, opt,
                                                          batch, 1)
        outs.append((params, met))
    np.testing.assert_allclose(outs[0][1]["loss"], outs[1][1]["loss"],
                               rtol=1e-5)
    assert outs[0][1]["tokens"] == outs[1][1]["tokens"] == 8 * 16
    for (_, a), (_, b) in zip(sharding.leaves(outs[0][0]),
                              sharding.leaves(outs[1][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("target", [1 << 10, 96 << 10, 1 << 30])
def test_bucketed_accumulation_is_bitwise_plain(target):
    """Bucketed microbatch accumulation (a bucket a leaf, several, one)
    gives the bits of the leaf-by-leaf sum: parameters, AdamW state and
    metrics of 2 steps, with the bf16 parameters and fp32 masters of the
    full configs."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=17,
                                  global_batch=4))
    runs = []
    for bucket in (None, target):
        scfg = StepConfig(microbatches=2, grad_bucket_bytes=bucket,
                          seq_chunk=8, warmup_steps=1)
        params, opt = build_init(cfg, CPU, scfg)(0)
        step_fn = build_train_step(cfg, CPU, scfg)
        mets = []
        for k in range(2):
            params, opt, m = step_fn(params, opt, data.global_batch(k), k)
            mets.append(m)
        runs.append((params, opt, mets))
    (p0, o0, m0), (p1, o1, m1) = runs
    assert m0 == m1
    for (_, a), (_, b) in zip(sharding.leaves((p0, o0)),
                              sharding.leaves((p1, o1))):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


# ---------------------------------------------------------------------------
# bucketing against the reference
# ---------------------------------------------------------------------------


def _bucket_tree(rng):
    shapes = {"embed": (11, 6), "final_norm": {"scale": (6,)},
              "layers": [{"w": (6, 5), "b": (5,)}, {"w": (6, 7), "b": (7,)}],
              "lm_head": (6, 300)}
    return jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(tree)


@pytest.mark.parametrize("target", [1, 100, 200, 1024, 1 << 20])
def test_bucket_plan_pack_unpack_match_reference(target):
    tree = _bucket_tree(np.random.default_rng(target))
    ref_plan = ref_bucketing.bucket_plan(tree, target_bytes=target)
    ours = _torch_tree(tree)
    plan = bucketing.bucket_plan(ours, target_bytes=target)
    assert plan.buckets == ref_plan.buckets
    assert plan.leaf_shapes == ref_plan.leaf_shapes
    assert plan.leaf_dtypes == ref_plan.leaf_dtypes
    assert plan.bucket_elements() == ref_plan.bucket_elements()
    got = bucketing.pack(ours, plan)
    want = ref_bucketing.pack(tree, ref_plan)
    assert len(got) == len(want) == plan.n_buckets
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = bucketing.unpack([g * 2 for g in got], plan)
    ref_back = ref_bucketing.unpack([w * 2 for w in want], ref_plan)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_back)[0]
    flat = list(sharding.leaves(back))
    assert len(flat) == len(flat_ref)
    for (path, g), (ref_path, w) in zip(flat, flat_ref):
        assert "/".join(map(str, path)) == "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in ref_path)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unpack_restores_leaf_dtypes_and_structure():
    tree = {"a": torch.ones(3, dtype=torch.bfloat16),
            "b": [torch.arange(4.0).reshape(2, 2), torch.zeros(())]}
    plan = bucketing.bucket_plan(tree, target_bytes=8)
    back = bucketing.unpack(bucketing.pack(tree, plan), plan)
    assert back["a"].dtype == torch.bfloat16
    assert isinstance(back["b"], list) and back["b"][1].shape == ()
    assert torch.equal(back["b"][0], tree["b"][0])
    f32 = bucketing.unpack(bucketing.pack(tree, plan), plan, torch.float32)
    assert f32["a"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the training route and what raises
# ---------------------------------------------------------------------------


def test_training_forward_never_calls_flash(monkeypatch):
    """The tp-1 step attends through blockwise attention: a flash wrapper
    that raises is never reached, while serving's forward does reach it."""
    def no_flash(*a, **k):
        raise AssertionError("flash_attention called")

    monkeypatch.setattr(layers, "flash_attention", no_flash)
    cfg = get_config("smollm-360m").reduced()
    scfg = StepConfig(seq_chunk=8, warmup_steps=1)
    params, opt = build_init(cfg, CPU, scfg)(0)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=17,
                                   global_batch=2)).global_batch(0)
    _, _, m = build_train_step(cfg, CPU, scfg)(params, opt, batch, 0)
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    with pytest.raises(AssertionError, match="flash_attention called"):
        model.forward(cfg, params, batch["tokens"])


def test_ssm_step_runs_the_model_block_and_refuses_tp():
    """At tp 1 the ssm step runs the model's own Mamba-2 block (no
    runner): its loss and gradients are ``model.loss_fn``'s.  ART-TP runs
    the dense block only, so tp 2 raises, as the reference's runner takes
    only the dense block."""
    cfg = get_config("mamba2-2.7b").reduced()
    scfg = StepConfig(seq_chunk=8, warmup_steps=1, peak_lr=0.0,
                      weight_decay=0.0)
    params, opt = build_init(cfg, CPU, scfg)(0)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=17,
                                   global_batch=2)).global_batch(0)
    tree = sharding.map_leaves(lambda _, t: t.clone().requires_grad_(True),
                               params)
    want, _ = model.loss_fn(cfg, tree, {k: torch.as_tensor(v).long()
                                        for k, v in batch.items()},
                            z_loss=scfg.z_loss)
    want.backward()
    norm = torch.sqrt(sum((t.grad.double() ** 2).sum()
                          for _, t in sharding.leaves(tree))).item()
    _, _, m = build_train_step(cfg, CPU, scfg)(params, opt, batch, 0)
    np.testing.assert_allclose(m["loss"], want.item(), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], norm, rtol=1e-5)
    with pytest.raises(ValueError, match="dense-only"):
        build_train_step(cfg, Group(rank=0, size=2,
                                    device=torch.device("cpu")), scfg)


def test_refuse_autograd_raises_only_while_recording():
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_autograd("k", torch.ones(2), x, None)
    refuse_autograd("k", torch.ones(2), None)
    with torch.no_grad():
        refuse_autograd("k", x)


def test_launcher_runs_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    args = ["--device", "cpu", "--steps", "3", "--seq-len", "16",
            "--global-batch", "4", "--ckpt-dir", str(tmp_path)]
    t = launch_train.main(args)
    assert [h["step"] for h in t.history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in t.history)
    t = launch_train.main(args[:3] + ["5"] + args[4:] + ["--microbatches",
                                                          "2"])
    assert [h["step"] for h in t.history] == [4, 5]
    assert "restored step 3" in capsys.readouterr().out
    # the launcher takes a grid (tests/test_torch_train_mesh.py); a model
    # axis beside an expert axis still raises
    with pytest.raises(NotImplementedError, match="item 7"):
        launch_train.main(args + ["--model-axis", "2", "--expert-axis", "2"])


def test_example_train_lm_small_runs(tmp_path, capsys):
    from repro_torch.examples import train_lm

    train_lm.main(["--small", "--device", "cpu", "--steps", "20",
                   "--ckpt-dir", str(tmp_path)])
    assert capsys.readouterr().out.rstrip().endswith("train_lm OK")


def test_launcher_and_example_train_mamba2(tmp_path, capsys):
    """Reduced mamba2 through the launcher (3 steps, then a resume to 5 in
    2 microbatches, the ssm leaves through the checkpoint) and through
    ``train_lm --small`` (the loss falls)."""
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as launch_train

    args = ["--arch", "mamba2-2.7b", "--device", "cpu", "--seq-len", "16",
            "--global-batch", "4", "--ckpt-dir", str(tmp_path / "ck"),
            "--steps"]
    t = launch_train.main(args + ["3"])
    assert [h["step"] for h in t.history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in t.history)
    t = launch_train.main(args + ["5", "--microbatches", "2"])
    assert [h["step"] for h in t.history] == [4, 5]
    assert "restored step 3" in capsys.readouterr().out
    train_lm.main(["--arch", "mamba2-2.7b", "--small", "--device", "cpu",
                   "--steps", "20", "--ckpt-dir", str(tmp_path / "lm")])
    assert capsys.readouterr().out.rstrip().endswith("train_lm OK")


def test_launcher_trains_reduced_zamba2_and_refuses_full(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """Reduced zamba2 through the launcher (2 steps); ``--full`` at its
    published 81 layers refuses on memory, stating the bytes, before any
    parameter is drawn; ``--full --layers 2`` is admitted (it reaches the
    draw), printed as a depth cut."""
    from repro_torch.launch import train as launch_train

    t = launch_train.main(["--arch", "zamba2-7b", "--device", "cpu",
                           "--seq-len", "16", "--global-batch", "4",
                           "--steps", "2", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in t.history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in t.history)

    def no_init(*a, **k):
        raise AssertionError("parameters drawn")

    monkeypatch.setattr(model, "init_params", no_init)
    monkeypatch.setattr(steps, "init_params", no_init)
    full = ["--arch", "zamba2-7b", "--full", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "full")]
    with pytest.raises(SystemExit, match=r"81 layers needs 139\.1 GB"):
        launch_train.main(full)
    with pytest.raises(AssertionError, match="parameters drawn"):
        launch_train.main(full + ["--layers", "2"])
    assert "n_layers 81 → 2" in capsys.readouterr().out


def test_trainer_and_launcher_raise_without_device(monkeypatch, tmp_path):
    """With no GPU, the Trainer and the launcher raise unless asked for the
    CPU (the device policy of every entry point)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm-360m").reduced()
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=17,
                                  global_batch=2))
    tcfg = TrainerConfig(total_steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, StepConfig(), tcfg, data)
    assert Trainer(cfg, StepConfig(), tcfg, data,
                   device="cpu").group.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
