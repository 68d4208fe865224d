"""The port's zamba2 hybrid against the reference, on reduced ``zamba2-7b``
in fp32 (5 Mamba-2 layers, a shared attention application after every 2,
2 shared blocks, 4/2 heads at hd 16, ``ssm_chunk`` 8): the bridge, the
parameter count and init, forward logits, bulk prefill, chunked prefill
with the hybrid carry, decode steps at mixed per-row positions and
``slot_write``.  A 7-layer variant (3 applications: blocks 0, 1, 0) holds
that the parameters follow ``g % n_shared_blocks`` while the caches follow
the application ``g``.

The reference's parameters cross to the port through
``repro_torch.bridge``; token inputs are numpy arrays from a seed.  fp32
tolerance 1e-5, as for mamba2 (``tests/test_torch_ssm.py``): the
reference scans with ``ssd_jnp`` and attends blockwise, the port runs the
kernels' plain versions, and the sums run in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import decode as ref_decode
from repro.models import model as ref_model
from repro.models import prefill as ref_prefill
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.dist import sharding
from repro_torch.dist.steps import slot_write
from repro_torch.models import decode, model, prefill

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "zamba2-7b"
CACHE = ("ssm_state", "conv_state", "attn_k", "attn_v", "slot_pos", "pos")
CARRY = ("ssm_state", "conv_state", "attn_k", "attn_v", "pos")
#: the reference's decode step, compiled once for the module
_ref_decode_step = jax.jit(ref_decode.decode_step, static_argnums=0)


def _close(ours, ref, msg=""):
    np.testing.assert_allclose(ours.detach().cpu().numpy(), np.asarray(ref),
                               err_msg=msg, **TOL)


def _setup(n_layers=None):
    ref_cfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    if n_layers:
        ref_cfg = dataclasses.replace(ref_cfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    return (ref_cfg, ref_params, cfg,
            params_from_reference(jax.tree.map(np.asarray, ref_params)))


@pytest.fixture(scope="module")
def arch():
    """(ref cfg, ref params, port cfg, port params): one reference init
    shared by every test of the module."""
    return _setup()


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_bridge_unstacks_layers_and_shared_blocks(arch):
    _, ref_params, cfg, params = arch
    assert (cfg.n_layers, cfg.hybrid_period, cfg.n_shared_blocks) == (5, 2, 2)
    assert len(params["layers"]) == 5
    assert isinstance(params["shared_blocks"], list)
    assert len(params["shared_blocks"]) == 2
    for i, block in enumerate(params["shared_blocks"]):
        assert set(block) == {"ln1", "attn", "ln2", "mlp"}
        np.testing.assert_array_equal(
            block["attn"]["wq"].numpy(),
            np.asarray(ref_params["shared_blocks"]["attn"]["wq"][i]))
    assert model.count_params(params) == model.count_params_analytic(cfg)


@pytest.mark.parametrize("reduced", [False, True])
def test_count_params_analytic_matches_reference(reduced):
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    if reduced:
        cfg, ref = cfg.reduced(), ref.reduced()
    assert model.count_params_analytic(cfg) == \
        ref_model.count_params_analytic(ref)
    if not reduced:
        assert model.count_params_analytic(cfg) == 6_956_658_896
    else:
        assert model.count_params(model.init_params(cfg, 0, "cpu")) == \
            model.count_params_analytic(cfg)


def test_init_params_follow_reference_distributions(arch):
    """Every leaf has the reference's shape and type; the fixed parts
    (norm scales, the Mamba-2 decays and skips) its values; the shared
    blocks' output projections the backbone's depth scale."""
    _, _, cfg, params = arch
    want = dict(sharding.leaves(params))
    got = dict(sharding.leaves(model.init_params(cfg, seed=0, device="cpu")))
    assert set(got) == set(want)
    for path, t in got.items():
        assert t.shape == want[path].shape and t.dtype == want[path].dtype, \
            path
        if path[-1] in ("scale", "a_log", "dt_bias", "d_skip", "conv_b"):
            torch.testing.assert_close(t, want[path], rtol=0, atol=0)
    big = dataclasses.replace(cfg, d_model=256, d_ff=512)
    wo = model.init_params(big, seed=0, device="cpu")["shared_blocks"][1][
        "attn"]["wo"]
    scale = 0.02 / np.sqrt(2 * cfg.n_layers)
    assert abs(wo.std().item() / scale - 0.88) < 0.05     # ±2σ cut


def test_forward_logits(arch):
    ref_cfg, ref_params, cfg, params = arch
    toks = _tokens(cfg, 2, 13, seed=1)
    ref_logits, _ = ref_model.forward(ref_cfg, ref_params, jnp.asarray(toks))
    _close(model.forward(cfg, params, torch.from_numpy(toks).long()),
           ref_logits)


@pytest.mark.parametrize("s", [2, 13])
def test_bulk_prefill_cache_and_logits(arch, s):
    """S = 2 is shorter than the conv tail: the tail is zero-padded."""
    ref_cfg, ref_params, cfg, params = arch
    toks = _tokens(cfg, 2, s, seed=2)
    ref_cache, ref_logits = ref_prefill.prefill(ref_cfg, ref_params,
                                                jnp.asarray(toks))
    cache, logits = prefill.prefill(cfg, params,
                                    torch.from_numpy(toks).long())
    assert set(cache) == set(ref_cache) == set(CACHE)
    assert cache["attn_k"].shape == (2, 2, cfg.n_kv_heads, s, 16)
    _close(logits, ref_logits, "logits")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)


def test_chunked_prefill_sequence(arch):
    """Cuts on ``ssm_chunk`` (8) multiples; the carry after each chunk and
    the finished cache match the reference's, and the chunked cache is the
    bulk cache."""
    ref_cfg, ref_params, cfg, params = arch
    s = 21
    toks = _tokens(cfg, 1, s, seed=3)
    cuts = prefill.prefill_chunk_cuts(s, chunk_len=4, multiple=cfg.ssm_chunk)
    assert cuts == [(0, 8), (8, 16), (16, 21)]
    assert prefill.chunk_support(cfg) == (True, "")
    ref_scr = ref_prefill.init_prefill_scratch(ref_cfg, 1, s)
    scr = prefill.init_prefill_scratch(cfg, 1, s, "cpu")
    assert set(scr) == set(ref_scr) == set(CARRY)
    for lo, hi in cuts:
        ref_scr, ref_logits = ref_prefill.prefill_chunk(
            ref_cfg, ref_params, ref_scr, jnp.asarray(toks[:, lo:hi]), lo)
        scr, logits = prefill.prefill_chunk(
            cfg, params, scr, torch.from_numpy(toks[:, lo:hi]).long(), lo)
        _close(logits, ref_logits, f"chunk logits at {lo}")
        for k in CARRY:
            _close(scr[k], ref_scr[k], f"{k} after chunk {lo}")
    ref_cache = ref_prefill.scratch_to_cache(ref_cfg, ref_scr, cache_len=32)
    cache = prefill.scratch_to_cache(cfg, scr, cache_len=32)
    assert set(cache) == set(ref_cache) == set(CACHE)
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)
    bulk, _ = prefill.prefill(cfg, params, torch.from_numpy(toks).long(),
                              cache_len=32)
    for k in CACHE:
        _close(cache[k], bulk[k].numpy(), f"chunked vs bulk {k}")


def test_decode_steps_at_mixed_positions(arch):
    """A batch-2 cache whose rows were prefilled to different lengths,
    written row by row with ``slot_write``, decoded for 4 steps."""
    ref_cfg, ref_params, cfg, params = arch
    lens, cap = (5, 9), 16
    ref_cache = ref_decode.init_cache(ref_cfg, 2, cap)
    cache = decode.init_cache(cfg, 2, cap, "cpu")
    assert set(cache) == set(ref_cache) == set(CACHE)
    for i, n in enumerate(lens):
        toks = _tokens(cfg, 1, n, 10 + n)
        ref_row, _ = ref_prefill.prefill(ref_cfg, ref_params,
                                         jnp.asarray(toks), cache_len=cap)
        ref_cache = {k: (v.at[i].set(ref_row[k][0]) if k in ("pos",
                                                            "slot_pos")
                         else v.at[:, i].set(ref_row[k][:, 0]))
                     for k, v in ref_cache.items()}
        row, _ = prefill.prefill(cfg, params, torch.from_numpy(toks).long(),
                                 cache_len=cap)
        slot_write(cache, row, i)
    for k in CACHE:
        _close(cache[k], ref_cache[k], f"written {k}")
    feed = _tokens(cfg, 4, 2, seed=20)
    for step in range(4):
        ref_cache, ref_logits = _ref_decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(feed[step]))
        cache, logits = decode.decode_step(
            cfg, params, cache, torch.from_numpy(feed[step]).long())
        _close(logits, ref_logits, f"decode logits step {step}")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)


def test_slot_write_touches_only_its_row(arch):
    _, _, cfg, params = arch
    cache = decode.init_cache(cfg, 3, 16, "cpu")
    assert not decode.supports_paged(cfg)
    gen = torch.Generator().manual_seed(0)
    for k in ("ssm_state", "conv_state", "attn_k", "attn_v"):
        cache[k].copy_(torch.randn(cache[k].shape, generator=gen))
    cache["pos"].copy_(torch.tensor([3, 4, 5]))
    cache["slot_pos"].copy_(torch.arange(48).view(3, 16))
    before = {k: v.clone() for k, v in cache.items()}
    row, _ = prefill.prefill(cfg, params,
                             torch.from_numpy(_tokens(cfg, 1, 7, 40)).long(),
                             cache_len=16)
    slot_write(cache, row, 1)
    for k in CACHE:
        axis = 0 if k in ("pos", "slot_pos") else 1
        for i in (0, 2):
            assert torch.equal(cache[k].select(axis, i),
                               before[k].select(axis, i)), (k, i)
        assert torch.equal(cache[k].select(axis, 1),
                           row[k].select(axis, 0).to(cache[k].dtype)), k


@pytest.fixture(scope="module")
def three_apps():
    """7 Mamba-2 layers at period 2: applications 0, 1, 2 run blocks 0,
    1, 0, then one trailing layer."""
    return _setup(n_layers=7)


def test_applications_run_block_g_mod_n_and_own_cache(three_apps):
    """Each application passes its block (g % 2) to the runner; perturbing
    block 1 leaves application 0's K/V as they were and moves 1 and 2
    (which follow it); perturbing block 0 moves application 0."""
    _, _, cfg, params = three_apps
    assert model.n_applications(cfg) == 3
    seen = []

    def runner(cfg_, p, x, positions):
        seen.append(next(i for i, b in enumerate(params["shared_blocks"])
                         if b is p))
        return model.dense_block(cfg_, p, x, positions)

    toks = torch.from_numpy(_tokens(cfg, 1, 11, seed=5)).long()
    model.forward(cfg, params, toks, runner=runner)
    assert seen == [0, 1, 0]
    base, _ = prefill.prefill(cfg, params, toks)
    for block, moved in ((1, (1, 2)), (0, (0, 1, 2))):
        pert = dict(params, shared_blocks=[dict(b) for b in
                                           params["shared_blocks"]])
        pert["shared_blocks"][block] = dict(
            pert["shared_blocks"][block],
            attn=dict(pert["shared_blocks"][block]["attn"],
                      wk=pert["shared_blocks"][block]["attn"]["wk"] * 2))
        cache, _ = prefill.prefill(cfg, pert, toks)
        for g in range(3):
            same = torch.equal(cache["attn_k"][g], base["attn_k"][g])
            assert same == (g not in moved), (block, g)


def test_three_applications_match_reference(three_apps):
    """Forward logits, the bulk cache (one K/V per application, the
    trailing layer's state) and two decode steps on the 3-application
    variant."""
    ref_cfg, ref_params, cfg, params = three_apps
    toks = _tokens(cfg, 2, 11, seed=6)
    ref_logits, _ = ref_model.forward(ref_cfg, ref_params, jnp.asarray(toks))
    _close(model.forward(cfg, params, torch.from_numpy(toks).long()),
           ref_logits, "forward")
    ref_cache, ref_logits = ref_prefill.prefill(ref_cfg, ref_params,
                                                jnp.asarray(toks),
                                                cache_len=16)
    cache, logits = prefill.prefill(cfg, params,
                                    torch.from_numpy(toks).long(),
                                    cache_len=16)
    assert cache["attn_k"].shape[0] == 3 and cache["ssm_state"].shape[0] == 7
    _close(logits, ref_logits, "prefill logits")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)
    feed = _tokens(cfg, 2, 2, seed=7)
    for step in range(2):
        ref_cache, ref_logits = _ref_decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(feed[step]))
        cache, logits = decode.decode_step(
            cfg, params, cache, torch.from_numpy(feed[step]).long())
        _close(logits, ref_logits, f"decode step {step}")
    for k in CACHE:
        _close(cache[k], ref_cache[k], f"decoded {k}")


def test_train_step_runs_at_tp1_and_refuses_tp():
    """The hybrid trains at tp 1 (its shared applications through the
    dense-block runner) and raises at tp 2: ART-TP runs the dense block
    only, as the reference's runner does."""
    from repro_torch.dist.group import Group
    from repro_torch.dist.steps import StepConfig, build_train_step

    cfg = get_config(ARCH).reduced()
    scfg = StepConfig(seq_chunk=8, warmup_steps=1)
    assert callable(build_train_step(
        cfg, Group(rank=0, size=1, device=torch.device("cpu")), scfg))
    with pytest.raises(ValueError, match="dense-only"):
        build_train_step(cfg, Group(rank=0, size=2,
                                    device=torch.device("cpu")), scfg)
