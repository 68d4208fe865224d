"""The port's TP training path against the reference's.

* the pieces: ``chunked_ce_loss`` (and its gradients), AdamW,
  ``warmup_cosine``, ``clip_by_global_norm``, ``blockwise_attention``
  (forward and gradients: causal, window, ``q_offset``, GQA), the TP
  placement and ``bridge.shard_params``, ``SyntheticLM``;
* the TP step on reduced ``h2o-danube-1.8b`` in fp32 at TP 2 and 4 over
  gloo groups of CPU ranks, fed the reference's parameters (through
  ``bridge.shard_params``) and the reference's ``SyntheticLM`` batches,
  against ``build_train_step`` with ``TransportPolicy(tp="fused")`` on a
  ``(1, tp)`` mesh for 2 steps: (loss, grad_norm) at 1e-5 relative, and
  every parameter leaf by the parameter rule at 1e-5 (mean |Δ| within
  1e-5 of the leaf's mean magnitude; max |Δ| within 2·peak_lr + 1e-5 of
  its largest, since AdamW's first update is ±lr wherever the gradient is
  not zero, so an element whose gradient is rounding noise can flip);
* replicated leaves bitwise equal on every rank; the hop functions'
  call counts from the schedule (remat "none" and "full");
* microbatch accumulation at TP 2 (2 microbatches) against the
  reference's fused step with ``microbatches=2``, at the same tolerances;
* every ART-TP policy builds a step; the paths not ported raise.

One gloo world per TP size is spawned for the module.
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
from repro.dist.loss import chunked_ce_loss as ref_chunked_ce_loss
from repro.dist.steps import StepConfig as RefStepConfig
from repro.dist.steps import TransportPolicy as RefTransportPolicy
from repro.dist.steps import build_init as ref_build_init
from repro.dist.steps import build_train_step as ref_build_train_step
from repro.launch.mesh import make_host_mesh
from repro.models import layers as ref_layers
from repro.models.model import init_params as ref_init_params
from repro.optim import adamw as ref_adamw
from repro.optim import clip as ref_clip
from repro.optim import schedule as ref_schedule
from repro_torch.bridge import params_from_reference, shard_params
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.dist import rank_tasks, sharding
from repro_torch.dist.group import Group, RankPool
from repro_torch.dist.loss import chunked_ce_loss
from repro_torch.dist.steps import (
    StepConfig,
    TransportPolicy,
    build_train_step,
)
from repro_torch.models import layers
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    warmup_cosine,
)

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "h2o-danube-1.8b"
STEP_KW = dict(seq_chunk=8, warmup_steps=1)
#: the reference's (loss, grad_norm) for 2 steps of this run, identical at
#: TP 2 and TP 4 and for the fused and xla transports
RECORDED = [(5.602902, 2.235377), (5.541286, 2.284376)]


@pytest.fixture(scope="module")
def pools():
    worlds = {n: RankPool(n, device="cpu") for n in (2, 4)}
    yield worlds
    for pool in worlds.values():
        pool.close()


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a), jax.device_get(tree))


_REF = {}


def _reference(tp, micro=1):
    """The reference's fused TP run: initial params, batches, per-step
    (loss, grad_norm) and the final params, as numpy."""
    if (tp, micro) in _REF:
        return _REF[tp, micro]
    cfg = ref_get_config(ARCH).reduced()
    mesh = make_host_mesh(data=1, model=tp)
    scfg = RefStepConfig(transport=RefTransportPolicy(tp="fused"),
                         microbatches=micro, **STEP_KW)
    data = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=17, global_batch=2))
    bundle = ref_build_train_step(cfg, mesh, scfg,
                                  batch_specs(16, 2, cfg.vocab_size))
    params, opt = ref_build_init(cfg, mesh, scfg)[0](jax.random.PRNGKey(0))
    params0 = _tree_np(params)
    batches, metrics = [], []
    for step in range(2):
        batch = data.global_batch(step)
        batches.append({k: np.asarray(v) for k, v in batch.items()})
        params, opt, m = bundle.fn(params, opt, batch, jnp.int32(step))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    _REF[tp, micro] = dict(params0=params0, batches=batches,
                           metrics=metrics, params=_tree_np(params))
    return _REF[tp, micro]


_PORT = {}


def _port(pools, tp, micro=1, **kw):
    key = (tp, micro, repr(sorted(kw.items())))
    if key not in _PORT:
        ref = _reference(tp, micro)
        _PORT[key] = pools[tp].run(
            rank_tasks.train, ARCH, steps=2, reduced=True,
            step_overrides=dict(STEP_KW, microbatches=micro),
            params_np=ref["params0"], batches=ref["batches"],
            return_params=True, **kw)
    return _PORT[key]


# ---------------------------------------------------------------------------
# the TP step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_loss_and_grad_norm_match_reference(pools, tp):
    ref = _reference(tp)
    for rank_res in _port(pools, tp):
        got = [(m["loss"], m["grad_norm"]) for m in rank_res["metrics"]]
        np.testing.assert_allclose(got, ref["metrics"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(got, RECORDED, rtol=1e-5, atol=0)


def _check_parameter_rule(ref, res, tp):
    peak_lr = StepConfig().peak_lr
    t = 1e-5
    for rank, rank_res in enumerate(res):
        want = {"/".join(map(str, p)): v.numpy() for p, v in sharding.leaves(
            shard_params(ref["params"], rank, tp, scheme="art"))}
        assert set(rank_res["params"]) == set(want)
        for name, w in want.items():
            g = rank_res["params"][name]
            d = np.abs(g - w)
            assert d.mean() <= t * np.abs(w).mean(), (rank, name)
            assert d.max() <= 2 * peak_lr + t * np.abs(w).max(), (rank, name)


@pytest.mark.parametrize("tp", [2, 4])
def test_params_after_two_steps_pass_parameter_rule(pools, tp):
    _check_parameter_rule(_reference(tp), _port(pools, tp), tp)


def test_tp2_microbatches_match_reference(pools):
    """Two microbatches of one row at TP 2: the fp32 accumulation of the
    TP step against the reference's fused step with ``microbatches=2``
    (loss and grad norm 1e-5 relative, parameters by the parameter rule
    at 1e-5)."""
    ref = _reference(2, micro=2)
    res = _port(pools, 2, micro=2)
    for rank_res in res:
        got = [(m["loss"], m["grad_norm"]) for m in rank_res["metrics"]]
        np.testing.assert_allclose(got, ref["metrics"], rtol=1e-5, atol=0)
        assert [m["tokens"] for m in rank_res["metrics"]] == [32.0, 32.0]
    _check_parameter_rule(ref, res, 2)


@pytest.mark.parametrize("tp", [2, 4])
def test_replicated_leaves_bitwise_equal_across_ranks(pools, tp):
    """The replicated leaves bitwise equal on every rank; ``embed`` and
    ``lm_head`` are vocab shards, not among them: gathered over the ranks
    they hold the V rows (columns) once each, and equal the reference's
    leaves by the parameter rule."""
    res = _port(pools, tp)
    names = set(res[0]["replicated"])
    assert {"final_norm/scale", "layers/0/attn/wk",
            "layers/1/ln2/scale"} <= names
    assert not {"embed", "lm_head"} & names
    for rank_res in res[1:]:
        assert rank_res["replicated"] == res[0]["replicated"]
        assert {"embed", "lm_head"} <= set(rank_res["sharded"])
    for name in names:      # the digests come from the same bits
        a = res[0]["params"][name]
        for rank_res in res[1:]:
            np.testing.assert_array_equal(rank_res["params"][name], a)
    ref = _reference(tp)
    vocab = get_config(ARCH).reduced().vocab_size
    peak_lr, t = StepConfig().peak_lr, 1e-5
    for name, dim in sharding.VOCAB_PARALLEL.items():
        parts = [r["params"][name] for r in res]
        assert all(p.shape[dim] == vocab // tp for p in parts)
        got, want = np.concatenate(parts, axis=dim), ref["params"][name]
        assert got.shape == want.shape
        d = np.abs(got - want)
        assert d.mean() <= t * np.abs(want).mean(), name
        assert d.max() <= 2 * peak_lr + t * np.abs(want).max(), name


def _head_chunks(tp, seq=16, seq_chunk=STEP_KW["seq_chunk"]):
    """The vocab-parallel CE's chunks a microbatch: ``seq_chunk / tp``
    local rows of each rank's ``seq / tp`` a chunk."""
    return -(-(seq // tp) // max(seq_chunk // tp, 1))


def _hop_calls(tp, layers_, remat):
    """Plain-version calls of one step on the emulated schedule: per layer
    two AG edges (q, up‖gate) and two RS edges (o, down) forward, the
    other op for each in backward, and the forward again under remat;
    the vocab-parallel head's AG edge forward and its RS edge backward a
    CE chunk (not recomputed); bidirectional half-rings above 2.  The
    whole-ring kernels' plain versions never run (the CPU takes the
    emulated schedule)."""
    bidir = tp > 2
    per_ag = {"consume_matmul": 2 * tp if bidir else tp}
    per_rs = {"matmul_tile": 2 if bidir else 1,
              "consume_matmul_acc": 2 * (tp - 1) if bidir else tp - 1}
    passes = 3 if remat == "full" else 2
    ag_calls = rs_calls = (layers_ * (2 * (passes - 1) + 2)
                           + _head_chunks(tp))
    return {"consume_matmul": ag_calls * per_ag["consume_matmul"],
            "matmul_tile": rs_calls * per_rs["matmul_tile"],
            "consume_matmul_acc": rs_calls * per_rs["consume_matmul_acc"],
            "ag_matmul_ring": 0, "rs_matmul_ring": 0}


@pytest.mark.parametrize("tp", [2, 4])
def test_hop_calls_follow_the_schedule(pools, tp):
    want = _hop_calls(tp, 2, "none")
    for rank_res in _port(pools, tp):
        for plain, launches in zip(rank_res["plain"], rank_res["launches"]):
            assert plain == want
            assert sum(launches.values()) == 0


def test_remat_full_recomputes_blocks_and_matches(pools):
    tp = 4
    base = _port(pools, tp)
    res = _port(pools, tp, cfg_overrides={"remat": "full"})
    for a, b in zip(res, base):
        np.testing.assert_allclose(
            [(m["loss"], m["grad_norm"]) for m in a["metrics"]],
            [(m["loss"], m["grad_norm"]) for m in b["metrics"]], rtol=1e-6)
        assert a["plain"][0] == _hop_calls(tp, 2, "full")
        for name, v in a["params"].items():
            np.testing.assert_allclose(v, b["params"][name], rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# the vocab-parallel embedding and head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_embedding_is_the_replicated_lookup(pools, tp):
    """Each rank's rows from its vocab shard and the reduce-scatter equal
    the replicated lookup's rows bit for bit, and the shards' gradients,
    gathered, equal the replicated lookup's gradient bit for bit."""
    rng = np.random.default_rng(tp)
    table = rng.standard_normal((256, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, size=(2, 16))
    tokens[0, :4] = [0, 256 // tp - 1, 256 // tp, 255]    # shard ends
    cot = rng.standard_normal((2, 16, 64)).astype(np.float32)
    res = pools[tp].run(rank_tasks.vocab_embed, table, tokens, cot)
    want = torch.from_numpy(table).requires_grad_(True)
    rows = want[torch.from_numpy(tokens)]
    (rows * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(
        np.concatenate([r["rows"] for r in res], axis=1),
        rows.detach().numpy())
    np.testing.assert_array_equal(
        np.concatenate([r["grad"] for r in res], axis=0), want.grad.numpy())


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_ce_matches_reference(pools, tp, tied, monkeypatch):
    """The vocab-parallel head and CE (the AG edge over each rank's vocab
    columns, the ranks' log-sum-exps combined a token) against the
    reference's ``chunked_ce_loss`` and ``jax.grad`` on the same hidden
    rows: metrics at 1e-5 (tokens exact), the ranks' losses summing to
    the reference's, and the gradients of the hidden rows and of the head
    shards, gathered, at 1e-5.  Masked labels, labels at both ends of
    every shard, and a tied head (the ``embed`` shard transposed)."""
    import repro.dist.loss as ref_loss

    cfg = dataclasses.replace(ref_get_config(ARCH).reduced(),
                              tie_embeddings=tied)
    v, d = cfg.vocab_size, cfg.d_model
    rng = np.random.default_rng(10 * tp + tied)
    hidden = rng.standard_normal((2, 16, d)).astype(np.float32)
    head = (0.3 * rng.standard_normal((v, d) if tied else (d, v))
            ).astype(np.float32)
    labels = rng.integers(0, v, size=(2, 16))
    ends = [e for r in range(tp) for e in (r * v // tp, (r + 1) * v // tp - 1)]
    labels[1, :len(ends)] = ends
    labels[0, [1, 6, 11]] = -1                        # masked positions
    monkeypatch.setattr(ref_loss, "forward_hidden",
                        lambda cfg_, p, tokens, fe: (p["hidden"], 0.0))
    name = "embed" if tied else "lm_head"
    params = {"hidden": jnp.asarray(hidden), name: jnp.asarray(head)}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: ref_chunked_ce_loss(
            cfg, p, {"tokens": jnp.asarray(labels),
                     "labels": jnp.asarray(labels)}, seq_chunk=6),
        has_aux=True)(params)
    res = pools[tp].run(rank_tasks.vocab_ce, ARCH, hidden, labels, head,
                        seq_chunk=6, cfg_overrides=dict(tie_embeddings=tied))
    for r in res:
        np.testing.assert_allclose(r["metrics"]["loss"], float(loss), **TOL)
        for k in ("ce", "z_loss"):
            np.testing.assert_allclose(r["metrics"][k], float(metrics[k]),
                                       **TOL)
        assert r["metrics"]["tokens"] == float(metrics["tokens"]) == 29.0
        assert r["launches"] == dict.fromkeys(r["launches"], 0)
    np.testing.assert_allclose(sum(r["loss"] for r in res), float(loss),
                               **TOL)
    np.testing.assert_allclose(
        np.concatenate([r["dh"] for r in res], axis=1),
        np.asarray(grads["hidden"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        np.concatenate([r["dhead"] for r in res], axis=0 if tied else 1),
        np.asarray(grads[name]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("vocab,tp", [(256, 2), (256, 4), (250, 2),
                                      (250, 4)])
def test_vocab_placement_matches_reference_param_pspecs(vocab, tp):
    """``embed`` and ``lm_head`` split their vocab dim exactly where the
    reference's ``param_pspecs`` puts ``model`` on it on a ``(1, tp)``
    host mesh, and stay replicated where its divisibility fallback drops
    the axis (250 over 4); ``bridge.shard_params`` cuts them so."""
    from repro.dist.sharding import param_pspecs

    cfg = dataclasses.replace(ref_get_config(ARCH).reduced(),
                              vocab_size=vocab)
    full = jax.eval_shape(lambda: ref_init_params(cfg,
                                                  jax.random.PRNGKey(0)))
    specs = param_pspecs(cfg, make_host_mesh(data=1, model=tp), full)
    for name, dim in sharding.VOCAB_PARALLEL.items():
        shape = tuple(full[name].shape)
        place = sharding.placement((name,), "model", shape, tp,
                                   scheme="art")
        split = specs[name][dim] == "model"
        assert place == (("row" if dim == 0 else "col") if split
                         else "rep"), (name, specs[name])
        assert split == (vocab % tp == 0)
        part = shard_params({name: np.zeros(shape, np.float32)}, 1, tp,
                            scheme="art")
        assert part[name].shape[dim] == (vocab // tp if split else vocab)


def test_indivisible_vocab_trains_replicated(pools):
    """A vocab the line does not divide (250 over 4) keeps ``embed`` and
    ``lm_head`` whole on every rank (the reference's fallback), and the
    TP step takes the replicated lookup and head: one step against the
    reference's fused step at 1e-5, its parameters by the rule, and the
    two leaves among the replicated, bitwise equal on every rank."""
    cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), vocab_size=250)
    mesh = make_host_mesh(data=1, model=4)
    scfg = RefStepConfig(transport=RefTransportPolicy(tp="fused"), **STEP_KW)
    batch = RefSyntheticLM(RefDataConfig(vocab_size=250, seq_len=17,
                                         global_batch=2)).global_batch(0)
    bundle = ref_build_train_step(cfg, mesh, scfg, batch_specs(16, 2, 250))
    params, opt = ref_build_init(cfg, mesh, scfg)[0](jax.random.PRNGKey(0))
    params0 = _tree_np(params)
    params, _, m = bundle.fn(params, opt, batch, jnp.int32(0))
    ref = dict(params=_tree_np(params))
    res = pools[4].run(
        rank_tasks.train, ARCH, steps=1, reduced=True,
        cfg_overrides=dict(vocab_size=250), step_overrides=STEP_KW,
        params_np=params0, return_params=True,
        batches=[{k: np.asarray(a) for k, a in batch.items()}])
    for r in res:
        got = (r["metrics"][0]["loss"], r["metrics"][0]["grad_norm"])
        np.testing.assert_allclose(got, (float(m["loss"]),
                                         float(m["grad_norm"])),
                                   rtol=1e-5, atol=0)
        assert {"embed", "lm_head"} <= set(r["replicated"])
        assert r["replicated"] == res[0]["replicated"]
        assert r["params"]["embed"].shape == (250, cfg.d_model)
    _check_parameter_rule(ref, res, 4)


@pytest.mark.parametrize("tp", [2, 4])
def test_rep_all_reduce_leaves_out_the_vocab_shards(pools, tp):
    """At TP n with V divisible by n a rank holds V/n rows of ``embed``
    and V/n columns of ``lm_head``, and the all-reduce of the replicated
    leaves' gradients over the line sends the fp32 gradients of the
    replicated leaves alone: their bytes, every step, without the
    embedding's and the head's."""
    cfg = get_config(ARCH).reduced()
    res = _port(pools, tp)
    for r in res:
        rep = sum(r["params"][name].size for name in r["replicated"])
        assert [w["bytes"] for w in r["rep_wire"]] == [4 * rep] * 2
        assert r["params"]["embed"].shape == (cfg.vocab_size // tp,
                                              cfg.d_model)
        assert r["params"]["lm_head"].shape == (cfg.d_model,
                                                cfg.vocab_size // tp)
        assert not {"embed", "lm_head"} & set(r["replicated"])


def _cpu_group(size):
    return Group(rank=0, size=size, device=torch.device("cpu"))


@pytest.mark.parametrize("size,scfg,kw,match", [
    (2, StepConfig(transport=TransportPolicy(tp="fused",
                                             compress_cross_pod=True)),
     {}, "data axis"),
])
def test_unported_paths_raise(size, scfg, kw, match):
    """Compression inside the step is not wired, as in the reference.
    (The reference's GSPMD path, ``tp="xla"`` and ``use_art=False``,
    trains: ``tests/test_torch_tp_xla.py``.)"""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    with pytest.raises(NotImplementedError, match=match):
        build_train_step(cfg, _cpu_group(size), scfg)


@pytest.mark.parametrize("tp", ["fused", "ring", "bidir", "auto"])
def test_every_art_tp_policy_builds(tp):
    """Every ART-TP family the reference takes builds a step (their values
    are held to the reference in ``tests/test_torch_overlap_train.py``)."""
    cfg = get_config(ARCH).reduced()
    assert callable(build_train_step(cfg, _cpu_group(2), StepConfig(
        transport=TransportPolicy(tp=tp))))


def test_transport_policy_validates_like_reference():
    """The port keeps the TP class of the reference's policy: the same
    values accepted and refused, the same defaults."""
    for tp in ("xla", "ring", "bidir", "fused", "auto"):
        assert TransportPolicy(tp=tp).tp == RefTransportPolicy(tp=tp).tp
    for bad in ("nccl", "gasnet"):
        with pytest.raises(ValueError):
            RefTransportPolicy(tp=bad)
        with pytest.raises(ValueError):
            TransportPolicy(tp=bad)
    ref = dataclasses.asdict(RefTransportPolicy())
    for name, value in dataclasses.asdict(TransportPolicy()).items():
        assert ref[name] == value, name
    ref_fields = dataclasses.asdict(RefStepConfig())
    for name, value in dataclasses.asdict(StepConfig()).items():
        assert ref_fields[name] == value, name


def test_remat_dots_raises():
    """``remat="dots"`` (keep the products with no batch dimension,
    recompute the rest) trains: the dense model's hidden and every
    gradient bitwise equal to ``"none"``'s; only a policy the reference
    lacks raises (the name is kept from when ``"dots"`` raised)."""
    from repro_torch.models.model import forward_hidden, init_params

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=(2, 20)))
    outs = []
    for remat in ("none", "dots"):
        cfg = dataclasses.replace(get_config(ARCH).reduced(), remat=remat)
        params = init_params(cfg, seed=0, device="cpu")
        for _, t in sharding.leaves(params):
            t.requires_grad_(True)
        hidden = forward_hidden(cfg, params, toks,
                                core=layers.blockwise_core(cfg))
        (hidden.float() ** 2).sum().backward()
        outs.append([hidden.detach()] + [t.grad for _, t in
                                         sharding.leaves(params)])
    for a, b in zip(*outs):                 # (lm_head has no gradient here)
        assert (a is None and b is None) or torch.equal(a, b)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), remat="offload")
    with pytest.raises(ValueError, match="offload"):
        forward_hidden(cfg, init_params(cfg, seed=0, device="cpu"), toks)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_chunked_ce_loss_and_grads_match_reference():
    cfg = ref_get_config(ARCH).reduced()
    ref_params = ref_init_params(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 16))
    labels = rng.integers(0, cfg.vocab_size, size=(2, 16))
    labels[0, :3] = -1                                  # masked positions
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_chunked_ce_loss(cfg, p, batch, seq_chunk=5),
        has_aux=True))(ref_params)

    params = params_from_reference(_tree_np(ref_params))
    for _, t in sharding.leaves(params):
        t.requires_grad_(True)
    got, got_m = chunked_ce_loss(
        get_config(ARCH).reduced(), params,
        {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)},
        seq_chunk=5)
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), **TOL)
    for k in ("loss", "ce", "z_loss", "tokens"):
        want = float(loss) if k == "loss" else float(metrics[k])
        np.testing.assert_allclose(got_m[k], want, **TOL)
    want_g = params_from_reference(_tree_np(grads))
    for (path, g), (_, w) in zip(sharding.leaves(params),
                                 sharding.leaves(want_g)):
        np.testing.assert_allclose(g.grad.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(param_dtype):
    rng = np.random.default_rng(0)
    shapes = [(5, 7), (3,), (4, 2, 3)]
    p_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    acfg = dict(lr=1e-2, weight_decay=0.1)
    ref_cfg = ref_adamw.AdamWConfig(**acfg)
    ref_p = [jnp.asarray(p).astype(param_dtype) for p in p_np]
    ref_state = ref_adamw.adamw_init(ref_p, ref_cfg)
    ours = [torch.from_numpy(p).to(getattr(torch, param_dtype))
            for p in p_np]
    state = adamw_init(ours, AdamWConfig(**acfg))
    for step, lr in enumerate([0.0, 1e-2, 5e-3]):
        g_np = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        ref_p, ref_state = ref_adamw.adamw_update(
            [jnp.asarray(g) for g in g_np], ref_state, ref_p, ref_cfg, lr)
        adamw_update([torch.from_numpy(g) for g in g_np], state, ours,
                     AdamWConfig(**acfg), lr)
        for a, b in zip(ours, ref_p):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), **TOL)
        for key in ("mu", "nu", "master"):
            for a, b in zip(state[key], ref_state[key]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert state["step"] == int(ref_state["step"]) == 3


def test_warmup_cosine_matches_reference():
    kw = dict(peak_lr=3e-4, warmup_steps=3, total_steps=10)
    for step in range(14):
        want = float(ref_schedule.warmup_cosine(step, **kw))
        np.testing.assert_allclose(warmup_cosine(step, **kw), want,
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(1)
    g_np = [rng.standard_normal(s).astype(np.float32)
            for s in [(6, 4), (9,), (2, 2, 2)]]
    want, want_norm = ref_clip.clip_by_global_norm(
        [jnp.asarray(g) for g in g_np], max_norm)
    got, norm = clip_by_global_norm([torch.from_numpy(g.copy())
                                     for g in g_np], max_norm)
    np.testing.assert_allclose(norm, float(want_norm), **TOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("sq,skv,q_offset,window,hq,hkv,chunk", [
    (20, 20, None, None, 4, 2, 8),     # causal, ragged chunks, GQA
    (20, 20, None, 8, 2, 2, 8),        # sliding window 8
    (6, 20, 10, None, 4, 2, 4),        # a mid-sequence chunk at q_offset
    (7, 30, 12, 8, 4, 1, 16),          # windowed chunk, 4 heads per kv head
])
def test_blockwise_attention_and_grads_match_reference(
        sq, skv, q_offset, window, hq, hkv, chunk):
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((2, hq, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, hkv, skv, 16)).astype(np.float32)
    v = rng.standard_normal((2, hkv, skv, 16)).astype(np.float32)
    ct = rng.standard_normal((2, hq, sq, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=chunk, kv_chunk=chunk,
              q_offset=q_offset)
    @jax.jit
    def fwd_bwd(a, b, c, g):
        out, vjp = jax.vjp(
            lambda a_, b_, c_: ref_layers.blockwise_attention(a_, b_, c_,
                                                              **kw), a, b, c)
        return (out,) + vjp(g)

    want = fwd_bwd(*(jnp.asarray(t) for t in (q, k, v, ct)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    got = layers.blockwise_attention(qt, kt, vt, **kw)
    (got * torch.from_numpy(ct)).sum().backward()
    for a, b in zip([got, qt.grad, kt.grad, vt.grad], want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)


def test_shard_params_follow_the_placement_rules():
    cfg = ref_get_config(ARCH).reduced()
    full = _tree_np(ref_init_params(cfg, jax.random.PRNGKey(0)))
    tp = 4
    for rank in range(tp):
        shard = shard_params(full, rank, tp, scheme="art")
        for i in range(cfg.n_layers):
            lp = shard["layers"][i]
            f = cfg.d_ff // tp
            np.testing.assert_array_equal(
                lp["mlp"]["w_up"].numpy(),
                full["layers"]["mlp"]["w_up"][i][:, rank * f:(rank + 1) * f])
            np.testing.assert_array_equal(
                lp["mlp"]["w_down"].numpy(),
                full["layers"]["mlp"]["w_down"][i][rank * f:(rank + 1) * f])
            hq = cfg.n_heads // tp * cfg.head_dim
            np.testing.assert_array_equal(
                lp["attn"]["wq"].numpy(),
                full["layers"]["attn"]["wq"][i][:, rank * hq:(rank + 1) * hq])
            np.testing.assert_array_equal(
                lp["attn"]["wo"].numpy(),
                full["layers"]["attn"]["wo"][i][rank * hq:(rank + 1) * hq])
            np.testing.assert_array_equal(lp["attn"]["wk"].numpy(),
                                          full["layers"]["attn"]["wk"][i])
        v = cfg.vocab_size // tp
        np.testing.assert_array_equal(shard["embed"].numpy(),
                                      full["embed"][rank * v:(rank + 1) * v])
        np.testing.assert_array_equal(
            shard["lm_head"].numpy(),
            full["lm_head"][:, rank * v:(rank + 1) * v])
    d = cfg.d_model
    assert [sharding.placement((n,), "model", (d,) * (n != "scale") + (d,),
                               tp, scheme="art") for n in
            ("wq", "w_up", "w_gate", "wo", "w_down", "wk", "wv",
             "scale")] == ["col"] * 3 + ["row"] * 2 + ["rep"] * 3
    v = cfg.vocab_size
    kw = dict(scheme="art")
    assert [sharding.placement(("embed",), "model", (v, d), tp, **kw),
            sharding.placement(("lm_head",), "model", (d, v), tp, **kw),
            sharding.placement(("embed",), "model", (250, d), tp, **kw),
            sharding.placement(("lm_head",), "model", (d, 250), tp, **kw),
            sharding.placement(("embed",), "model", (v, d), 1, **kw),
            sharding.placement(("lm_head",), "model", (d, v), 1, **kw),
            sharding.placement(("embed",), "expert", (v, d), tp)] == \
        ["row", "col", "rep", "rep", "rep", "rep", "rep"]
    with pytest.raises(ValueError, match="logical leaf's shape"):
        sharding.placement(("embed",))


def test_synthetic_lm_is_step_indexed_ngram_stream():
    cfg = DataConfig(vocab_size=97, seq_len=33, global_batch=4, seed=5)
    data = SyntheticLM(cfg)
    b0, again, b1 = data.global_batch(0), SyntheticLM(cfg).global_batch(0), \
        data.global_batch(1)
    assert b0["tokens"].shape == b0["labels"].shape == (4, 32)
    assert torch.equal(b0["tokens"], again["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    full = torch.cat([b0["tokens"], b0["labels"][:, -1:]], dim=1)
    assert torch.equal(full[:, 1:], b0["labels"])
    assert int(full.min()) >= 0 and int(full.max()) < 97
    halves = [data.batch(0, s, 2)["tokens"] for s in (0, 1)]
    assert halves[0].shape == (2, 32) and not torch.equal(*halves)
    # most tokens come from the n-gram bank: count bank-aligned matches
    grams = data.grams
    seq = full[:, :32].reshape(4, 4, cfg.gram_len)
    hits = (seq[:, :, None, :] == grams[None, None]).all(-1).any(-1)
    assert hits.float().mean() > 0.2


def test_union_spans_merges_overlaps():
    """The TP step's profiled kernel spans: overlapping and touching spans
    merge, and the union comes in order."""
    assert rank_tasks.union_spans([(5, 7), (1, 3), (2, 4), (7, 9),
                                   (10, 11)]) == [(1, 4), (5, 9), (10, 11)]
    assert rank_tasks.union_spans([]) == []


def test_ring_profile_idles_its_margin_around_the_calls():
    """Phase 7's profile of the ring: the calls sit ``PROFILE_MARGIN_S``
    inside the profile on both sides, so no rank's profiler starts or
    stops while another rank's hops run (a profile can lose records)."""
    import time
    from types import SimpleNamespace

    calls = []
    t0 = time.perf_counter()
    got = rank_tasks._ring_profile(SimpleNamespace(device=torch.device("cpu")),
                                   lambda: calls.append(time.perf_counter()),
                                   3)
    t1 = time.perf_counter()
    margin = rank_tasks.PROFILE_MARGIN_S
    assert margin > 0 and len(calls) == 3
    assert calls[0] - t0 >= margin and t1 - calls[-1] >= margin
    assert got == {"hop_ms": 0.0, "hop_events": 0.0, "copy_ms": 0.0}
