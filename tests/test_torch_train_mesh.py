"""The port's train step, Trainer and launcher over a grid of ranks
against the reference's on a host mesh.

* dense grid: reduced ``h2o-danube-1.8b`` in fp32 at data 2 × model 2
  (the fused ring inside each model line) and at data 4 × model 1, fed
  the reference's parameters and batches, against ``build_train_step``
  on ``make_host_mesh(2, 2)`` / ``(4, 1)`` for 2 steps: (loss,
  grad_norm) at 1e-5 relative, every leaf by ``test_torch_train.py``'s
  parameter rule; again with 2 microbatches, ``grad_bucket_bytes`` set
  and masked labels (-1) that fall unevenly between the data shards;
  parameters bitwise equal across data ranks;
* expert grid: reduced ``llama4-scout-17b-a16e`` at data 2 × expert 2 on
  ``moe="ring"`` against the reference on a ``("data", "expert")`` mesh:
  loss, ``moe_aux`` and grad_norm at 1e-5, parameters by the same rule;
* the Trainer at 2 × 2 against the reference ``Trainer`` on
  ``make_host_mesh(2, 2)`` (3 steps at 1e-5, from the reference's
  initial parameters in a step-0 checkpoint), the restart from the step-2
  checkpoint bit for bit, the logical checkpoint read by the reference's
  ``load_checkpoint`` and restored onto a one-rank port run; a SIGTERM
  on one rank stopping every rank at the same checkpoint;
* ``python -m repro_torch.launch.train --device cpu --data-axis 2
  --model-axis 2`` trains at ``reduced()`` and writes a checkpoint;
* what the grid does not take raises.

One 4-rank gloo world for the module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.data.pipeline import batch_specs
from repro.dist.steps import StepConfig as RefStepConfig
from repro.dist.steps import TransportPolicy as RefTransportPolicy
from repro.dist.steps import build_init as ref_build_init
from repro.dist.steps import build_train_step as ref_build_train_step
from repro.launch.mesh import make_host_mesh as ref_make_host_mesh
from repro.runtime.trainer import Trainer as RefTrainer
from repro.runtime.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.bridge import params_from_reference, shard_params
from repro_torch.checkpoint import list_checkpoints, load_checkpoint
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import rank_tasks, sharding
from repro_torch.dist.group import Group, RankPool, as_grid
from repro_torch.dist.steps import (
    StepConfig,
    TransportPolicy,
    build_train_step,
    init_opt,
)
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.trainer import Trainer, TrainerConfig

DENSE = "h2o-danube-1.8b"
MOE = "llama4-scout-17b-a16e"
STEP_KW = dict(seq_chunk=8, warmup_steps=1)
SEQ, BATCH = 17, 4
T = 1e-5


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, device="cpu") as p:
        yield p


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), jax.device_get(tree))


def _mask_unevenly(batch):
    """Labels of the first rows masked (-1), more in row 0 than row 1:
    the data shards then count different tokens."""
    labels = np.array(batch["labels"])
    labels[0, :11] = -1
    labels[1, 4:6] = -1
    return dict(batch, labels=labels)


_REF = {}


def _reference(data, model, micro=1, bucket=None, masked=False):
    """The reference's step on ``make_host_mesh(data, model)``
    (``tp="fused"``): initial params, batches, per-step (loss, grad_norm)
    and the final params, as numpy."""
    key = (data, model, micro, bucket, masked)
    if key in _REF:
        return _REF[key]
    cfg = ref_get_config(DENSE).reduced()
    mesh = ref_make_host_mesh(data, model)
    scfg = RefStepConfig(transport=RefTransportPolicy(tp="fused"),
                         microbatches=micro, grad_bucket_bytes=bucket,
                         **STEP_KW)
    rows = BATCH * micro            # a row of each microbatch a data rank
    source = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=rows))
    bundle = ref_build_train_step(cfg, mesh, scfg, batch_specs(
        SEQ - 1, rows, cfg.vocab_size))
    params, opt = ref_build_init(cfg, mesh, scfg)[0](jax.random.PRNGKey(0))
    params0 = _np(params)
    batches, metrics = [], []
    for step in range(2):
        batch = {k: np.asarray(v) for k, v in
                 source.global_batch(step).items()}
        if masked:
            batch = _mask_unevenly(batch)
        batches.append(batch)
        params, opt, m = bundle.fn(params, opt, batch, jnp.int32(step))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    _REF[key] = dict(params0=params0, batches=batches, metrics=metrics,
                     params=_np(params))
    return _REF[key]


def _check_rule(ref_params, res, axis="model"):
    """``test_torch_train.py``'s parameter rule on every rank's leaves,
    each against the reference's leaf cut to the rank's inner shard."""
    peak_lr = StepConfig().peak_lr
    for r in res:
        inner, n = r["coords"][1], r["shape"][1]
        want = {"/".join(map(str, p)): v.numpy() for p, v in sharding.leaves(
            shard_params(ref_params, inner, n, axis=axis))}
        assert set(r["params"]) == set(want)
        for name, w in want.items():
            d = np.abs(r["params"][name] - w)
            assert d.mean() <= T * np.abs(w).mean(), (r["coords"], name)
            assert d.max() <= 2 * peak_lr + T * np.abs(w).max(), \
                (r["coords"], name)


def _check_data_ranks_equal(res):
    """Ranks that differ only in their data coordinate hold the same
    parameter bits."""
    by_inner = {}
    for r in res:
        by_inner.setdefault(r["coords"][1], []).append(r["digests"])
    for digests in by_inner.values():
        assert all(d == digests[0] for d in digests[1:])


DENSE_CASES = [(2, 2, 1, None, False), (4, 1, 1, None, False),
               (2, 2, 2, 4096, True), (4, 1, 2, 4096, True)]


@pytest.mark.parametrize("data,model,micro,bucket,masked", DENSE_CASES)
def test_dense_grid_matches_reference(pool, data, model, micro, bucket,
                                      masked):
    ref = _reference(data, model, micro, bucket, masked)
    res = pool.run(
        rank_tasks.train, DENSE, steps=2, reduced=True,
        step_overrides=dict(STEP_KW, microbatches=micro,
                            grad_bucket_bytes=bucket),
        params_np=ref["params0"], batches=ref["batches"],
        return_params=True, grid=dict(data=data, model=model))
    for r in res:
        got = [(m["loss"], m["grad_norm"]) for m in r["metrics"]]
        np.testing.assert_allclose(got, ref["metrics"], rtol=T, atol=0)
        tokens = [float((b["labels"] >= 0).sum()) for b in ref["batches"]]
        assert [m["tokens"] for m in r["metrics"]] == tokens
        # the data line carried the gradients: every leaf, fp32, each way
        sent = r["line_stats"][0]["data"]["sent_bytes"]
        assert sent > 0 and (model == 1 or
                             r["line_stats"][0]["model"]["hops"] > 0)
    _check_rule(ref["params"], res)
    _check_data_ranks_equal(res)


def test_expert_grid_matches_reference(pool):
    cfg = ref_get_config(MOE).reduced()
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = jax.sharding.Mesh(devs, ("data", "expert"))
    scfg = RefStepConfig(microbatches=2, transport=RefTransportPolicy(
        moe="ring"), **STEP_KW)
    source = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=8))
    bundle = ref_build_train_step(cfg, mesh, scfg,
                                  batch_specs(SEQ - 1, 8, cfg.vocab_size))
    params, opt = ref_build_init(cfg, mesh, scfg)[0](jax.random.PRNGKey(0))
    params0 = _np(params)
    batches, metrics = [], []
    for step in range(2):
        batch = {k: np.asarray(v) for k, v in
                 source.global_batch(step).items()}
        batches.append(batch)
        params, opt, m = bundle.fn(params, opt, batch, jnp.int32(step))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "moe_aux", "grad_norm")})
    res = pool.run(
        rank_tasks.train, MOE, steps=2, reduced=True, moe_transport="ring",
        step_overrides=dict(STEP_KW, microbatches=2), params_np=params0,
        batches=batches, return_params=True, grid=dict(data=2, expert=2))
    for r in res:
        for got, want in zip(r["metrics"], metrics):
            for key, v in want.items():
                np.testing.assert_allclose(got[key], v, rtol=T, atol=0)
    _check_rule(_np(params), res, axis="expert")
    _check_data_ranks_equal(res)


# ---------------------------------------------------------------------------
# the Trainer and the launcher
# ---------------------------------------------------------------------------


def _ref_trainer(tmp_path):
    cfg = ref_get_config(DENSE).reduced()
    scfg = RefStepConfig(**STEP_KW)
    source = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=SEQ, global_batch=BATCH))
    mesh = ref_make_host_mesh(2, 2)
    t = RefTrainer(cfg, scfg, RefTrainerConfig(
        total_steps=3, ckpt_dir=str(tmp_path / "ref"), ckpt_interval=2),
        source, mesh=mesh, log_fn=lambda _m: None)
    t.train()
    params0 = _np(ref_build_init(cfg, mesh, scfg)[0](jax.random.PRNGKey(0))
                  [0])
    batches = [{k: np.asarray(v) for k, v in source.global_batch(s).items()}
               for s in range(3)]
    return t.history, params0, batches


def test_trainer_grid_resumes_and_matches_reference(pool, tmp_path):
    ref_history, params0, batches = _ref_trainer(tmp_path)
    cfg = get_config(DENSE).reduced()
    ckpt = str(tmp_path / "port")
    # the reference's initial state as a step-0 checkpoint
    params = params_from_reference(params0)
    save_checkpoint(ckpt, 0, (params, init_opt(params, StepConfig())))
    kw = dict(data=2, model=2, ckpt_interval=2, reduced=True,
              step_overrides=STEP_KW, log=False, batches=batches)
    res = pool.run(rank_tasks.train_grid, DENSE, steps=3, ckpt_dir=ckpt,
                   resume_check=True, **kw)
    for r in res:
        assert r["resumed"], r["coords"]
        assert r["restore_seconds"] is not None
        got = [(h["loss"], h["grad_norm"]) for h in r["history"]]
        want = [(h["loss"], h["grad_norm"]) for h in ref_history]
        np.testing.assert_allclose(got, want, rtol=T, atol=0)
        # the first run's interval and final saves of step 2 (the second
        # a committed step's no-op write), the resumed run's final save
        assert [s for s, _ in r["ckpt_seconds"]] == [2, 2, 3]
    assert [s for s, _ in list_checkpoints(ckpt)] == [0, 2, 3]
    # a plain restart restores the final checkpoint of step 3: no step
    # left to take, every rank's state the resumed run's
    again = pool.run(rank_tasks.train_grid, DENSE, steps=3, ckpt_dir=ckpt,
                     **kw)
    for r, first in zip(again, res):
        assert r["history"] == [] and r["restore_seconds"] is not None
        assert r["digests"] == first["digests"]
    assert [s for s, _ in list_checkpoints(ckpt)] == [0, 2, 3]
    res = again

    # the logical checkpoint: the reference's reader gives the port's
    # arrays; each rank's state is its cut of them
    template = (params, init_opt(params, StepConfig()))
    back, _ = load_checkpoint(ckpt, template)
    ref_back, _ = ref_ckpt.load_checkpoint(ckpt, jax.tree.map(
        lambda t: np.zeros(t.shape, np.float32)
        if isinstance(t, torch.Tensor) else np.zeros((), np.int32),
        template, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for (path, a), (_, b) in zip(sharding.leaves(back),
                                 sharding.leaves(ref_back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
    for r in res:
        m = r["coords"][1]
        cut = sharding.shard_tree(back[0], m, 2)
        assert r["digests"] == {"/".join(map(str, p)): rank_tasks._digest(t)
                                for p, t in sharding.leaves(cut)}

    # restored onto one rank: the same logical state, nothing retrained
    one = Trainer(cfg, StepConfig(transport=TransportPolicy(tp="fused"),
                                  **STEP_KW),
                  TrainerConfig(total_steps=3, ckpt_dir=ckpt), SyntheticLM(
                      DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                 global_batch=BATCH)),
                  device="cpu", log_fn=lambda _m: None)
    got = one.train()
    assert got[2] == 3 and one.history == []
    for (_, a), (_, b) in zip(sharding.leaves(got[:2]),
                              sharding.leaves(back)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)


def test_sigterm_on_one_rank_stops_every_rank(pool, tmp_path):
    """A SIGTERM that reaches world rank 3 alone after step 2: every rank
    takes the preemption checkpoint at that boundary and stops there."""
    ckpt = str(tmp_path / "pre")
    res = pool.run(rank_tasks.train_grid, DENSE, steps=6, ckpt_dir=ckpt,
                   data=2, model=2, ckpt_interval=100, reduced=True,
                   step_overrides=STEP_KW, log=False, preempt_at=(3, 2),
                   dataset=dict(seq_len=SEQ, global_batch=BATCH))
    for r in res:
        assert [h["step"] for h in r["history"]] == [1, 2]
        assert [s for s, _ in r["ckpt_seconds"]] == [2]
    assert [s for s, _ in list_checkpoints(ckpt)] == [2]


def test_launcher_trains_over_a_grid(tmp_path):
    ckpt = str(tmp_path / "ck")
    out = launch_train.main(["--device", "cpu", "--data-axis", "2",
                             "--model-axis", "2", "--steps", "2",
                             "--global-batch", "4", "--seq-len", "16",
                             "--ckpt-dir", ckpt])
    assert [s for s, _ in list_checkpoints(ckpt)] == [2]
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])


def test_launcher_memory_refusal_counts_a_rank_per_process():
    """The launcher's state reckoning takes one rank's share of the model
    (its inner line's shards of the shapes alone, exactly what the port
    holds once drawn) times the ranks that share the card, and refuses
    before it draws a parameter."""
    from repro_torch.models.model import init_params

    for name, axis in ((DENSE, "model"), (MOE, "expert")):
        cfg = get_config(name).reduced()
        full = init_params(cfg, 0, "cpu")
        for n in (1, 2):
            held = sum(t.numel() for _, t in sharding.leaves(
                sharding.shard_tree(full, 0, n, axis)))
            assert launch_train.rank_params(cfg, axis, n) == held
    with pytest.raises(SystemExit, match=r"4 ranks of 36\.6 GB each"):
        launch_train.main(["--device", "cpu", "--full", "--arch", DENSE,
                           "--data-axis", "4"])


# ---------------------------------------------------------------------------
# what the grid does not take
# ---------------------------------------------------------------------------


def test_grid_paths_not_ported_raise():
    cpu = Group(rank=0, size=4, device=torch.device("cpu"))
    dense, moe = get_config(DENSE).reduced(), get_config(MOE).reduced()
    with pytest.raises(NotImplementedError, match="item 7.5"):
        make_host_mesh(cpu, data=1, model=2, expert=2)
    with pytest.raises(ValueError, match="needs 6 ranks"):
        make_host_mesh(cpu, data=3, model=2)
    # a dense model on an expert line, a MoE model on a model line
    for cfg, inner in ((dense, "expert"), (moe, "model")):
        with pytest.raises(NotImplementedError, match="item 7.5"):
            build_train_step(cfg, as_grid(cpu, inner), StepConfig(
                transport=TransportPolicy(tp="fused", moe="ring")))
    with pytest.raises(NotImplementedError, match="item 7.8"):
        build_train_step(dense, cpu, StepConfig(transport=TransportPolicy(
            tp="fused", compress_cross_pod=True)))
    with pytest.raises(ValueError, match="cross_pod"):
        TransportPolicy(cross_pod="nccl")
    assert dataclasses.asdict(TransportPolicy())["cross_pod"] == \
        dataclasses.asdict(RefTransportPolicy())["cross_pod"]
    with pytest.raises(NotImplementedError, match="item 7.5"):
        launch_train.main(["--device", "cpu", "--arch", MOE,
                           "--model-axis", "2"])
