"""The reference's default tensor parallelism (``TransportPolicy.tp="xla"``:
GSPMD over ``param_pspecs``) in the port, ``models/tp_block.py``, against
the reference.

* placement: every leaf of all ten archs at their published shapes
  (``init_params`` on the ``meta`` device, ``jax.eval_shape``: nothing
  drawn) at tp 2 and 4: the ``xla`` placement splits the dim the
  reference's ``param_pspecs`` puts ``model`` on, on a ``(1, tp)`` host
  mesh, and no other; the ``art`` placement is the same but for
  ``wk``/``wv``, whole;
* the train step in fp32 at ``reduced()``, fed the reference's
  parameters and batches, against ``build_train_step`` with
  ``TransportPolicy(tp="xla")`` on a ``(1, tp)`` host mesh for 2 steps:
  (loss, grad_norm) at 1e-5 relative and every leaf by
  ``tests/test_torch_train.py``'s parameter rule.  Cases: ``smollm`` at
  tp 2 and tp 4 (tp 4 cuts its two KV heads of 16 in halves), at tp 4
  with 6 query heads and 3 KV heads on both sides (a query head cut
  between two ranks, each attending it whole), ``h2o`` at
  tp 2, ``minicpm3`` (MLA) at tp 2, ``internvl2`` at tp 2 on the ``xla``
  path and on the ``fused`` path (the ART block, the patch rows joining
  the sequence before it is split), ``sequence_parallel=False`` and a
  length tp does not divide (the residual whole on every rank);
  replicated leaves bitwise equal on every rank;
* ``use_art=False`` under ``tp="fused"`` gives the ``xla`` step's values
  bit for bit, and ``remat="full"`` (each block recomputed with its
  collectives) the ``"none"`` values;
* a checkpoint written under ``xla`` by the ``Trainer`` on a data 2 ×
  model 2 grid restores bit for bit (the restart protocol), and restores
  under the ART path's placement;
* the families not ported at tp ≥ 2 raise ``NotImplementedError`` naming
  ROADMAP item 7.5b.

One gloo world of each size for the module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.data.pipeline import batch_specs
from repro.dist.sharding import param_pspecs
from repro.dist.steps import StepConfig as RefStepConfig
from repro.dist.steps import TransportPolicy as RefTransportPolicy
from repro.dist.steps import build_init as ref_build_init
from repro.dist.steps import build_train_step as ref_build_train_step
from repro.launch.mesh import make_host_mesh
from repro.models.model import init_params as ref_init_params
from repro_torch.bridge import shard_params
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.dist import rank_tasks, sharding
from repro_torch.dist.group import Group, RankPool, as_grid
from repro_torch.dist.steps import (
    StepConfig,
    TransportPolicy,
    build_train_step,
    init_opt,
)
from repro_torch.models.model import init_params

SMOLLM, H2O = "smollm-360m", "h2o-danube-1.8b"
MINICPM3, INTERNVL2 = "minicpm3-4b", "internvl2-2b"
STEP_KW = dict(seq_chunk=8, warmup_steps=1)
T = 1e-5


@pytest.fixture(scope="module")
def pools():
    worlds = {n: RankPool(n, device="cpu") for n in (2, 4)}
    yield worlds
    for pool in worlds.values():
        pool.close()


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), jax.device_get(tree))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

_SHAPES = {}


def _model_dims(arch, tp):
    """{leaf path without layer indices: the dim (counted from the end)
    the reference's ``param_pspecs`` puts ``model`` on, or None}."""
    if arch not in _SHAPES:
        cfg = ref_get_config(arch)
        _SHAPES[arch] = (cfg, jax.eval_shape(
            lambda: ref_init_params(cfg, jax.random.PRNGKey(0))))
    cfg, shapes = _SHAPES[arch]
    specs = param_pspecs(cfg, make_host_mesh(data=1, model=tp), shapes)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, spec in flat:
        key = tuple(str(getattr(k, "key", k)) for k in path)
        dims = [i - len(spec) for i, e in enumerate(spec)
                if e == "model" or (isinstance(e, tuple) and "model" in e)]
        assert len(dims) <= 1, (key, spec)
        out[key] = dims[0] if dims else None
    return out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_xla_placement_is_reference_param_pspecs(arch, tp):
    want = _model_dims(arch, tp)
    got, art = {}, {}
    for path, t in sharding.leaves(init_params(get_config(arch), 0, "meta")):
        key = tuple(str(k) for k in path if not isinstance(k, int))
        for scheme, out in (("xla", got), ("art", art)):
            place = sharding.placement(path, "model", tuple(t.shape), tp,
                                       scheme=scheme)
            dim = sharding.split_dim(place)
            assert out.setdefault(key, dim) == dim, key   # every layer alike
    assert got == want
    assert {k: v for k, v in art.items() if k[-1] not in ("wk", "wv")} == \
        {k: v for k, v in want.items() if k[-1] not in ("wk", "wv")}
    assert all(v is None for k, v in art.items() if k[-1] in ("wk", "wv"))


def test_placement_needs_its_scheme():
    with pytest.raises(ValueError, match="scheme"):
        sharding.placement(("layers", 0, "attn", "wk"), "model", (64, 32), 2)
    with pytest.raises(ValueError, match="scheme"):
        shard_params({"wq": np.zeros((4, 4), np.float32)}, 0, 2)
    assert sharding.placement(("moe", "w_up"), "expert") == "expert"


# ---------------------------------------------------------------------------
# the xla step against the reference's
# ---------------------------------------------------------------------------

_REF = {}


def _reference(arch, tp, seq=17, step_over=None, cfg_over=None):
    """The reference's ``tp="xla"`` step on a ``(1, tp)`` mesh (its
    ``reduced()`` config with ``cfg_over``): initial params, batches,
    per-step (loss, grad_norm), final params."""
    key = (arch, tp, seq, repr(sorted((step_over or {}).items())),
           repr(sorted((cfg_over or {}).items())))
    if key in _REF:
        return _REF[key]
    cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                              **(cfg_over or {}))
    scfg = RefStepConfig(transport=RefTransportPolicy(tp="xla"),
                         **dict(STEP_KW, **(step_over or {})))
    data = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=2))
    specs = batch_specs(seq - 1, 2, cfg.vocab_size)
    rng = np.random.default_rng(seq)
    embeds = None
    if cfg.frontend:
        embeds = [rng.standard_normal((2, cfg.frontend_tokens,
                                       cfg.frontend_dim)).astype(np.float32)
                  for _ in range(2)]
        specs = dict(specs, frontend_embeds=jax.ShapeDtypeStruct(
            embeds[0].shape, jnp.float32))
    mesh = make_host_mesh(data=1, model=tp)
    bundle = ref_build_train_step(cfg, mesh, scfg, specs)
    params, opt = ref_build_init(cfg, mesh, scfg)[0](jax.random.PRNGKey(0))
    params0 = _np(params)
    batches, metrics = [], []
    for step in range(2):
        batch = {k: np.asarray(v) for k, v in data.global_batch(step).items()}
        if embeds is not None:
            batch["frontend_embeds"] = embeds[step]
        batches.append(batch)
        params, opt, m = bundle.fn(params, opt, batch, jnp.int32(step))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    _REF[key] = dict(params0=params0, batches=batches, metrics=metrics,
                     params=_np(params))
    return _REF[key]


_PORT = {}


def _port(pools, arch, tp, transport="xla", seq=17, step_over=None,
          cfg_over=None, **kw):
    """The port's step fed ``_reference``'s parameters and batches;
    ``kw.cfg_overrides`` changes the port's config alone (what leaves the
    parameters' shapes as they are)."""
    key = (arch, tp, transport, seq, repr(sorted((step_over or {}).items())),
           repr(sorted((cfg_over or {}).items())), repr(sorted(kw.items())))
    if key not in _PORT:
        ref = _reference(arch, tp, seq, step_over, cfg_over)
        over = dict(cfg_over or {}, **kw.pop("cfg_overrides", {}))
        _PORT[key] = pools[tp].run(
            rank_tasks.train, arch, steps=2, reduced=True,
            tp_transport=transport, cfg_overrides=over or None,
            step_overrides=dict(STEP_KW, **(step_over or {})),
            params_np=ref["params0"], batches=ref["batches"],
            return_params=True, **kw)
    return _PORT[key]


def _check_parameter_rule(ref_params, res, tp):
    peak_lr = StepConfig().peak_lr
    for rank, r in enumerate(res):
        want = {"/".join(map(str, p)): v.numpy() for p, v in sharding.leaves(
            shard_params(ref_params, rank, tp, scheme=r["scheme"]))}
        assert set(r["params"]) == set(want)
        for name, w in want.items():
            d = np.abs(r["params"][name] - w)
            assert d.mean() <= T * np.abs(w).mean(), (rank, name)
            assert d.max() <= 2 * peak_lr + T * np.abs(w).max(), (rank, name)


#: 6 query heads and 3 KV heads of 16, on both sides: at tp 4 each rank
#: takes 24 rows of ``wo``, a head and a half (rank 1 attends heads 1–2,
#: which read KV heads 0 and 1), and 12 columns of ``wk``/``wv``
HEADS_CUT = {"n_heads": 6, "n_kv_heads": 3}

CASES = {
    "smollm-tp2": (SMOLLM, 2, "xla", 17, None, None),
    "smollm-tp4-kv-heads-cut": (SMOLLM, 4, "xla", 17, None, None),
    "smollm-tp4-query-heads-cut": (SMOLLM, 4, "xla", 17, None, HEADS_CUT),
    "h2o-tp2": (H2O, 2, "xla", 17, None, None),
    "minicpm3-tp2": (MINICPM3, 2, "xla", 17, None, None),
    "internvl2-tp2-xla": (INTERNVL2, 2, "xla", 17, None, None),
    "internvl2-tp2-fused": (INTERNVL2, 2, "fused", 17, None, None),
    "smollm-tp2-no-sequence-parallel": (SMOLLM, 2, "xla", 17,
                                        {"sequence_parallel": False}, None),
    "smollm-tp2-length-17": (SMOLLM, 2, "xla", 18, None, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_reference_xla_step(pools, case):
    arch, tp, transport, seq, step_over, cfg_over = CASES[case]
    ref = _reference(arch, tp, seq, step_over, cfg_over)
    res = _port(pools, arch, tp, transport, seq, step_over, cfg_over)
    for r in res:
        assert r["scheme"] == ("art" if transport == "fused" else "xla")
        got = [(m["loss"], m["grad_norm"]) for m in r["metrics"]]
        np.testing.assert_allclose(got, ref["metrics"], rtol=T, atol=0)
        # replicated leaves bitwise equal on every rank
        assert r["replicated"] == res[0]["replicated"]
    _check_parameter_rule(ref["params"], res, tp)


def test_kv_heads_cut_at_tp4_hold_quarter_heads(pools):
    """At tp 4 reduced smollm's ``wk``/``wv`` (2 KV heads of 16) split
    into 8 columns a rank, half a head, under ``xla``; whole under the
    ART block's placement."""
    res = _port(pools, SMOLLM, 4)
    cfg = get_config(SMOLLM).reduced()
    for r in res:
        for name in ("wk", "wv"):
            assert r["params"][f"layers/0/attn/{name}"].shape == (
                cfg.d_model, 8)
        assert "layers/0/attn/wk" in r["sharded"]
    full = init_params(cfg, 0, "meta")
    assert sharding.placement(("layers", 0, "attn", "wk"), "model",
                              tuple(full["layers"][0]["attn"]["wk"].shape),
                              4, scheme="art") == "rep"


def test_use_art_false_gives_the_xla_step(pools):
    """``use_art=False`` under a ring policy leaves TP to the reference's
    GSPMD path: the ``xla`` step's metrics and parameters bit for bit;
    ``remat="full"`` (blocks and their collectives recomputed in
    backward) gives the ``"none"`` values."""
    base = _port(pools, H2O, 2)
    for over in ({"use_art": False}, {"remat": "full"}):
        res = _port(pools, H2O, 2, "fused" if "use_art" in over else "xla",
                    cfg_overrides=over)
        for a, b in zip(res, base):
            assert a["scheme"] == "xla"
            got = [(m["loss"], m["grad_norm"]) for m in a["metrics"]]
            want = [(m["loss"], m["grad_norm"]) for m in b["metrics"]]
            if "use_art" in over:
                assert got == want and a["digests"] == b["digests"]
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6)
                for name, v in a["params"].items():
                    np.testing.assert_allclose(v, b["params"][name],
                                               rtol=1e-6, atol=1e-7)


def test_xla_checkpoint_restores_bit_for_bit(pools, tmp_path):
    """The ``Trainer`` under ``xla`` on data 2 × model 2 (reduced smollm):
    the step restored from its checkpoint equals the uninterrupted step
    bit for bit on every rank; the logical checkpoint then restores
    under the ART path's placement (``wk``/``wv`` whole), each rank's
    state its cut of the logical arrays."""
    ckpt = str(tmp_path / "ck")
    kw = dict(data=2, model=2, ckpt_interval=2, reduced=True,
              step_overrides=STEP_KW, log=False,
              dataset=dict(seq_len=17, global_batch=4))
    res = pools[4].run(rank_tasks.train_grid, SMOLLM, steps=3,
                       ckpt_dir=ckpt, resume_check=True, **kw)
    for r in res:
        assert r["scheme"] == "xla" and r["resumed"], r["coords"]
    art = pools[4].run(rank_tasks.train_grid, SMOLLM, steps=3,
                       ckpt_dir=ckpt, tp_transport="fused", **kw)
    cfg = get_config(SMOLLM).reduced()
    params = init_params(cfg, 0, "cpu")
    back, _ = load_checkpoint(ckpt, (params, init_opt(params, StepConfig())))
    for r in art:
        assert r["scheme"] == "art" and r["history"] == []
        cut = sharding.shard_tree(back[0], r["coords"][1], 2, scheme="art")
        assert r["digests"] == {"/".join(map(str, p)): rank_tasks._digest(t)
                                for p, t in sharding.leaves(cut)}


# ---------------------------------------------------------------------------
# what is not ported yet
# ---------------------------------------------------------------------------


def _cpu(size):
    return Group(rank=0, size=size, device=torch.device("cpu"))


@pytest.mark.parametrize("arch,tp,inner", [
    ("mamba2-2.7b", "xla", "model"),
    ("zamba2-7b", "xla", "model"),
    ("whisper-tiny", "xla", "model"),
    ("llama4-scout-17b-a16e", "xla", "model"),
    ("mamba2-2.7b", "fused", "model"),
])
def test_families_not_ported_at_tp2_raise(arch, tp, inner):
    """The ssm, hybrid and encoder-decoder families, a MoE model on a
    model axis, and a config the ART block rejects under a ring policy
    where the ``xla`` path cannot take it either: item 7.5b."""
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="item 7.5b"):
        build_train_step(cfg, as_grid(_cpu(2), inner), StepConfig(
            transport=TransportPolicy(tp=tp)))


def test_xla_path_takes_what_the_art_block_rejects():
    """Full-width ``smollm-360m`` (15 heads) at tp 2 under ``fused``:
    the ART block cannot split its heads, so the step takes the ``xla``
    path, as the reference's does (a step built, nothing drawn)."""
    from repro_torch.dist.steps import tp_scheme
    from repro_torch.models.artblock import supports_art_tp

    cfg = get_config(SMOLLM)
    scfg = StepConfig(transport=TransportPolicy(tp="fused"))
    assert not supports_art_tp(cfg, 2)
    assert tp_scheme(cfg, scfg, 2) == "xla"
    assert callable(build_train_step(cfg, _cpu(2), scfg))
    h2o = get_config(H2O)
    assert tp_scheme(h2o, scfg, 4) == "art"
    assert tp_scheme(dataclasses.replace(h2o, use_art=False), scfg,
                     4) == "xla"
