"""The port's tp-1 training of every family it serves, against the
reference's.

* For reduced ``llama4-scout-17b-a16e`` and ``grok-1-314b`` (MoE: every
  expert on the one device, top-1 with a shared expert and top-2
  GeGLU), ``minicpm3-4b`` (MLA, at its reduced head dims and at its full
  width's q/k 96, v 64), ``internvl2-2b`` (VLM, with patch embeddings)
  and ``whisper-tiny`` (encoder-decoder, with frames; 12 decoder rows
  over 16 encoder rows): the loss, the metrics and every gradient leaf of
  the port's ``chunked_ce_loss`` (attention through ``blockwise_core``)
  against ``jax.value_and_grad`` of the reference's, at 1e-5; then one
  tp-1 ``build_train_step`` in 2 microbatches (each cut of the batch
  carries its ``frontend_embeds``) against the reference's one-device
  ``build_train_step``: loss, metrics, grad norm and lr at 1e-5
  relative, every updated parameter at rtol = atol = 1e-5 (the rule of
  ``tests/test_torch_train_single.py``).
* The MoE layer under autograd: the gradients of ``layers.moe`` (through
  the renormalised top-k weights to the router, through ``torch.bmm`` to
  the stacked experts, through the capacity dispatch and the gather back
  to the rows) and of ``layers.moe_aux_loss`` against ``jax.grad`` of the
  reference's, at the published capacity factor and at 0.5, where the
  capacity drops rows.
* ``remat="dots"`` on reduced ``zamba2-7b``: gradients bitwise equal to
  ``"none"``'s and ``"full"``'s.  The products with no batch dimension
  (``aten.mm``, ``aten.addmm``, a ``bmm`` of batch 1) are counted by a
  ``TorchDispatchMode`` entered around the forward and backward: it sits
  below selective checkpointing's own modes, so it sees the ops that run
  and not those served from the checkpoint's cache.  ``"full"`` first
  shows that the count sees the recompute (more than ``"none"``); then
  ``"dots"`` computes exactly ``"none"``'s, while its batched products
  (attention's per-head einsums) are recomputed as ``"full"``'s are.
* One AdamW step with bf16 moments and no master on bf16 parameters
  against the reference's ``adamw_update``: within one bf16 rounding
  (2^-8 of each value) of it; and the sliced update of a large leaf
  gives the bits of the whole-leaf update.
* ``launch/train.py``: the optimizer state by the reference's
  ``step_config`` rule on the published config; the reduced MoE and MLA
  archs through the launcher; the frontend archs refused (the step takes
  ``batch["frontend_embeds"]``, the launcher's data makes none).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.dist.loss import chunked_ce_loss as ref_chunked_ce_loss
from repro.dist.steps import StepConfig as RefStepConfig
from repro.dist.steps import build_init as ref_build_init
from repro.dist.steps import build_train_step as ref_build_train_step
from repro.launch.mesh import make_host_mesh
from repro.models import layers as ref_layers
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.dist import sharding
from repro_torch.dist.group import Group
from repro_torch.dist.loss import chunked_ce_loss
from repro_torch.dist.steps import StepConfig, build_train_step, init_opt
from repro_torch.models import layers as L
from repro_torch.models import model
from repro_torch.optim import adamw as port_adamw

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = Group(rank=0, size=1, device=torch.device("cpu"))
STEP_KW = dict(microbatches=2, seq_chunk=5, warmup_steps=1)
MLA_FULL_DIMS = dict(qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
                     head_dim=96)
#: family case → (arch, config overrides, batch rows, text rows)
CASES = {
    "llama4-scout": ("llama4-scout-17b-a16e", {}, 4, 16),
    "grok-1": ("grok-1-314b", {}, 4, 16),
    "minicpm3": ("minicpm3-4b", {}, 4, 16),
    "minicpm3@96/64": ("minicpm3-4b", MLA_FULL_DIMS, 2, 12),
    "internvl2": ("internvl2-2b", {}, 4, 16),
    "whisper": ("whisper-tiny", {}, 4, 12),
}


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a), jax.device_get(tree))


def _configs(case):
    arch, over, _, _ = CASES[case]
    return (dataclasses.replace(ref_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    labels[0, :3] = -1                                  # masked positions
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend:
        batch["frontend_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k != "frontend_embeds"
            else torch.from_numpy(v) for k, v in batch.items()}


_REF = {}


def _reference(case):
    """The reference's parameters from one init, the batch, the gradient
    of its ``chunked_ce_loss`` and one step of its one-device
    ``build_train_step`` in 2 microbatches."""
    if case not in _REF:
        ref_cfg, _ = _configs(case)
        _, _, b, s = CASES[case]
        batch = _batch(ref_cfg, b, s, seed=len(_REF))
        mesh = make_host_mesh(data=1, model=1)
        scfg = RefStepConfig(**STEP_KW)
        params, opt = ref_build_init(ref_cfg, mesh, scfg)[0](
            jax.random.PRNGKey(0))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, mets), grads = jax.jit(jax.value_and_grad(
            lambda p: ref_chunked_ce_loss(ref_cfg, p, jb,
                                          seq_chunk=STEP_KW["seq_chunk"]),
            has_aux=True))(params)
        params0 = _tree_np(params)
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in jb.items()}
        bundle = ref_build_train_step(ref_cfg, mesh, scfg, specs)
        new_params, _, step_m = bundle.fn(params, opt, jb, jnp.int32(0))
        _REF[case] = dict(
            batch=batch, params0=params0, loss=float(loss),
            metrics={k: float(v) for k, v in mets.items()},
            grads=_tree_np(grads), params1=_tree_np(new_params),
            step_metrics={k: float(v) for k, v in step_m.items()})
    return _REF[case]


@pytest.mark.parametrize("case", CASES)
def test_loss_metrics_and_grads_match_reference(case):
    ref = _reference(case)
    _, cfg = _configs(case)
    params = params_from_reference(ref["params0"])
    for _, t in sharding.leaves(params):
        t.requires_grad_(True)
    loss, mets = chunked_ce_loss(cfg, params, _torch_batch(ref["batch"]),
                                 seq_chunk=STEP_KW["seq_chunk"],
                                 core=L.blockwise_core(cfg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    assert set(mets) == set(ref["metrics"]) | {"loss"}
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(mets[k], v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    if cfg.family == "moe":
        assert mets["moe_aux"] > 0
    want = dict(sharding.leaves(params_from_reference(ref["grads"])))
    for path, t in sharding.leaves(params):
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(g.numpy(), want[path].numpy(), **TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("case", CASES)
def test_tp1_step_matches_reference(case):
    ref = _reference(case)
    _, cfg = _configs(case)
    scfg = StepConfig(**STEP_KW)
    params = params_from_reference(ref["params0"])
    opt = init_opt(params, scfg)
    params, opt, m = build_train_step(cfg, CPU, scfg)(
        params, opt, _torch_batch(ref["batch"]), 0)
    assert set(m) == set(ref["step_metrics"])
    for k, v in ref["step_metrics"].items():
        np.testing.assert_allclose(m[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    want = dict(sharding.leaves(params_from_reference(ref["params1"])))
    for path, t in sharding.leaves(params):
        np.testing.assert_allclose(t.numpy(), want[path].numpy(), **TOL,
                                   err_msg=str(path))


# ---------------------------------------------------------------------------
# the MoE layer under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "grok-1-314b"])
def test_moe_layer_grads_match_reference(arch, cf):
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  capacity_factor=cf)
    cfg = dataclasses.replace(get_config(arch).reduced(), capacity_factor=cf)
    ref_moe = jax.tree.map(
        np.asarray, ref_layers.init_moe(ref_cfg, jax.random.PRNGKey(7)))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)

    _, _, keep, _, _ = ref_layers.moe_route(ref_cfg, ref_moe["router"],
                                            jnp.asarray(x))
    if cf < 1:                                  # the capacity drops rows
        assert not np.asarray(keep).all()

    def ref_fn(p, xx):
        return ((ref_layers.moe(ref_cfg, p, xx) * w).sum()
                + 3.0 * ref_layers.moe_aux_loss(ref_cfg, xx, p))

    want_p, want_x = jax.grad(ref_fn, argnums=(0, 1))(ref_moe,
                                                      jnp.asarray(x))
    moe = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                       .requires_grad_(True), ref_moe)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ((L.moe(cfg, moe, xt) * torch.from_numpy(w)).sum()
           + 3.0 * L.moe_aux_loss(cfg, xt, moe))
    out.backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL)
    flat_want = dict(sharding.leaves(jax.tree.map(np.asarray, want_p)))
    for path, t in sharding.leaves(moe):
        np.testing.assert_allclose(t.grad.numpy(), flat_want[path], **TOL,
                                   err_msg=str(path))


# ---------------------------------------------------------------------------
# remat="dots"
# ---------------------------------------------------------------------------


class _Products(TorchDispatchMode):
    """Counts the products that run: with no batch dimension
    (``aten.mm``, ``aten.addmm``, a ``bmm`` of batch 1) and batched."""

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if model._is_saved_product(func, args):
            self.count["unbatched"] += 1
        elif func is aten.bmm.default:
            self.count["batched"] += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_grads_bitwise_and_no_product_recomputed():
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, size=(2, 20)))
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}
    grads, counts = {}, {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                                  remat=remat)
        params = model.init_params(cfg, seed=0, device="cpu")
        for _, t in sharding.leaves(params):
            t.requires_grad_(True)
        with _Products() as seen:
            loss, _ = chunked_ce_loss(cfg, params, batch, seq_chunk=8,
                                      core=L.blockwise_core(cfg))
            loss.backward()
        grads[remat] = [t.grad for _, t in sharding.leaves(params)]
        counts[remat] = seen.count
    for remat in ("full", "dots"):
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(grads["none"], grads[remat])), remat
    # the count sees a recompute: "full" runs the forward's products again
    assert counts["full"]["unbatched"] > counts["none"]["unbatched"]
    assert counts["full"]["batched"] > counts["none"]["batched"]
    # "dots" runs no unbatched product twice, and recomputes the batched
    assert counts["dots"]["unbatched"] == counts["none"]["unbatched"]
    assert counts["dots"]["batched"] == counts["full"]["batched"]


# ---------------------------------------------------------------------------
# AdamW with bf16 moments and no master
# ---------------------------------------------------------------------------


def test_adamw_bf16_moments_no_master_matches_reference():
    """One step at the reference's ≥ 100 B settings on bf16 parameters
    (the moments already holding a step): both compute in fp32 and round
    to bf16 once, so each value is within one bf16 rounding of the
    reference's (2^-8 relative; the two agree bitwise unless an fp32
    last bit differs at a rounding boundary)."""
    rng = np.random.default_rng(11)
    shapes = [(33, 17), (64,), (3, 5, 7)]
    p = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    g = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in shapes]
    mu = [rng.standard_normal(s).astype(np.float32) * 0.01 for s in shapes]
    nu = [np.abs(rng.standard_normal(s)).astype(np.float32) * 1e-3
          for s in shapes]
    rcfg = RefAdamWConfig(moment_dtype="bfloat16", master_fp32=False)
    bf = jnp.bfloat16
    ref_p = [jnp.asarray(a, bf) for a in p]
    state = ref_adamw_init(ref_p, rcfg)
    state = dict(state, step=jnp.int32(1), mu=[jnp.asarray(a, bf)
                                               for a in mu],
                 nu=[jnp.asarray(a, bf) for a in nu])
    assert "master" not in state
    new_p, new_s = ref_adamw_update([jnp.asarray(a) for a in g], state,
                                    ref_p, rcfg, 1e-3)

    cfg = port_adamw.AdamWConfig(moment_dtype="bfloat16", master_fp32=False)
    tp = [torch.from_numpy(a).to(torch.bfloat16) for a in p]
    ts = port_adamw.adamw_init(tp, cfg)
    assert "master" not in ts and ts["mu"][0].dtype == torch.bfloat16
    ts.update(step=1, mu=[torch.from_numpy(a).to(torch.bfloat16)
                          for a in mu],
              nu=[torch.from_numpy(a).to(torch.bfloat16) for a in nu])
    port_adamw.adamw_update([torch.from_numpy(a) for a in g], ts, tp, cfg,
                            1e-3)
    assert ts["step"] == 2
    for got, want in ((tp, new_p), (ts["mu"], new_s["mu"]),
                      (ts["nu"], new_s["nu"])):
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(
                a.float().numpy(), np.asarray(b, np.float32),
                rtol=2.0 ** -8, atol=0)


def test_adamw_sliced_update_is_bitwise_whole(monkeypatch):
    """A leaf past ``UPDATE_SLICE`` elements is updated a slice at a time:
    the bits of the whole-leaf update, with and without a master."""
    rng = np.random.default_rng(5)
    runs = []
    for sl in (10 ** 9, 7):
        monkeypatch.setattr(port_adamw, "UPDATE_SLICE", sl)
        for master in (True, False):
            cfg = port_adamw.AdamWConfig(moment_dtype="bfloat16",
                                         master_fp32=master)
            rng = np.random.default_rng(5)
            p = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(torch.bfloat16) for s in ((9, 10), (5,))]
            st = port_adamw.adamw_init(p, cfg)
            for k in range(2):
                g = [torch.from_numpy(rng.standard_normal(t.shape)
                                      .astype(np.float32)) for t in p]
                port_adamw.adamw_update(g, st, p, cfg, 1e-2)
            runs.append(p + st["mu"] + st["nu"] + st.get("master", []))
    for a, b in zip(runs[:2], runs[2:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_optimizer_rule_follows_published_size():
    from repro_torch.launch import train as launch_train

    for arch in ("llama4-scout-17b-a16e", "grok-1-314b", "nemotron-4-340b"):
        assert launch_train.optimizer_state(get_config(arch)) == dict(
            moment_dtype="bfloat16", master_fp32=False), arch
    for arch in ("smollm-360m", "zamba2-7b", "minicpm3-4b", "internvl2-2b"):
        assert launch_train.optimizer_state(get_config(arch)) == dict(
            moment_dtype="float32", master_fp32=True), arch
    # llama4-scout at 1 of 48 layers: 4.27 B parameters, 12 B each
    cut = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              n_layers=1)
    assert model.count_params_analytic(cut) == 4_271_078_400
    assert launch_train.train_state_bytes(cut, "bfloat16", False) \
        == 12 * 4_271_078_400


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "minicpm3-4b"])
def test_launcher_trains_reduced_moe_and_mla(arch, tmp_path):
    from repro_torch.launch import train as launch_train

    t = launch_train.main(["--arch", arch, "--device", "cpu", "--seq-len",
                           "16", "--global-batch", "4", "--microbatches",
                           "2", "--steps", "2", "--layers", "1",
                           "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in t.history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in t.history)
    assert t.scfg.moment_dtype == ("bfloat16" if arch.startswith("llama4")
                                   else "float32")
    if arch.startswith("llama4"):
        assert all(h["moe_aux"] > 0 for h in t.history)


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-tiny"])
def test_launcher_refuses_frontend_archs(arch, tmp_path):
    from repro_torch.launch import train as launch_train

    with pytest.raises(ValueError, match=r"frontend_embeds"):
        launch_train.main(["--arch", arch, "--device", "cpu", "--steps",
                           "1", "--ckpt-dir", str(tmp_path)])


def test_step_zeroes_the_gradient_of_an_unreached_leaf():
    """A hybrid cut below one shared application (1 Mamba-2 layer, period
    2) never reaches its shared blocks: their gradient is zero, as the
    reference's, so AdamW only decays them, p (1 − lr·wd)."""
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), n_layers=1)
    scfg = StepConfig(**dict(STEP_KW, peak_lr=1e-2))
    params = model.init_params(cfg, seed=0, device="cpu")
    before = [t.clone() for _, t in sharding.leaves(params["shared_blocks"])]
    opt = init_opt(params, scfg)
    batch = _torch_batch(_batch(cfg, 2, 10, seed=0))
    _, _, m = build_train_step(cfg, CPU, scfg)(params, opt, batch, 0)
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    lr, wd = m["lr"], scfg.weight_decay
    for b, (_, t) in zip(before, sharding.leaves(params["shared_blocks"])):
        torch.testing.assert_close(t, b * (1 - lr * wd), rtol=1e-6,
                                   atol=0)
