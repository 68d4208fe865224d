"""The port's multi-head latent attention (MLA, ``minicpm3-4b``) against
the reference, in fp32 on two configs: reduced ``minicpm3-4b`` (2 layers,
4 heads, q/k and v head dims 16/16, latent 16) and a variant of it at
the full width's head dims (``qk_nope`` 64 + ``qk_rope`` 32 = 96 for q/k,
64 for v), which sends every attention call through the flash wrapper's
unequal pair (its plain version on the CPU).  Held: the parameters
(the bridge's nested ``q_norm``/``kv_norm``, the count against the
reference's analytic one, 4.26 B at full width), forward logits, bulk
prefill (``ckv``, ``krope``, ``slot_pos`` and logits), chunked prefill
with a ragged cut against the reference's chunks and against bulk,
``scratch_to_cache`` ≡ the bulk cache, decode steps at mixed per-row
positions against the reference's jitted ``decode_step`` (the absorbed
form over the latent), ``slot_write``, and token identity with the
reference ``Server`` (chunked and bulk; MLA has no paged layout, and its
training raises).

The reference's parameters cross to the port through
``repro_torch.bridge``; tokens are numpy arrays from a seed.  fp32
tolerance 1e-5: the reference attends blockwise over its whole scratch,
the port through the flash plain version over the rows a chunk sees, and
the sums run in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.mesh import make_host_mesh
from repro.models import decode as ref_decode
from repro.models import model as ref_model
from repro.models import prefill as ref_prefill
from repro.runtime import server as ref_server
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.dist.steps import slot_write
from repro_torch.kernels.flash_attention import FLASH
from repro_torch.models import decode, model, prefill
from repro_torch.runtime import server

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "minicpm3-4b"
CACHE = ("ckv", "krope", "slot_pos", "pos")
CARRY = ("ckv", "krope", "pos")
#: the full width's head dims on the reduced widths
FULL_DIMS = dict(qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64, head_dim=96)
VARIANTS = ("reduced", "full_dims")
_ref_decode_step = jax.jit(ref_decode.decode_step, static_argnums=0)


def _close(ours, ref, msg=""):
    np.testing.assert_allclose(ours.detach().cpu().numpy(), np.asarray(ref),
                               err_msg=msg, **TOL)


def _configs(variant):
    ref_cfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    if variant == "full_dims":
        ref_cfg = dataclasses.replace(ref_cfg, **FULL_DIMS)
        cfg = dataclasses.replace(cfg, **FULL_DIMS)
    return ref_cfg, cfg


@pytest.fixture(scope="module", params=VARIANTS)
def arch(request):
    """(ref cfg, ref params, port cfg, port params): one reference init
    a variant, shared by the module's parity tests."""
    ref_cfg, cfg = _configs(request.param)
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    return (ref_cfg, ref_params, cfg,
            params_from_reference(jax.tree.map(np.asarray, ref_params)))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _t(a):
    return torch.from_numpy(a).long()


@pytest.mark.parametrize("variant", VARIANTS + ("full",))
def test_count_params_analytic_matches_reference(variant):
    if variant == "full":
        cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    else:
        ref, cfg = _configs(variant)
    assert model.count_params_analytic(cfg) == \
        ref_model.count_params_analytic(ref)
    if variant == "full":
        assert model.count_params_analytic(cfg) == 4_261_902_848
    else:
        params = model.init_params(cfg, 0, "cpu")
        assert model.count_params(params) == model.count_params_analytic(cfg)


def test_bridge_and_init_follow_reference(arch):
    """Every leaf has the reference's shape and type (the nested norms
    too), and the norm scales its values."""
    from repro_torch.dist import sharding

    _, ref_params, cfg, params = arch
    attn = params["layers"][1]["attn"]
    assert set(attn) == {"w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm",
                         "w_uk", "w_uv", "wo"}
    np.testing.assert_array_equal(
        attn["kv_norm"]["scale"].numpy(),
        np.asarray(ref_params["layers"]["attn"]["kv_norm"]["scale"][1]))
    assert attn["w_uk"].shape == (cfg.kv_lora_rank,
                                  cfg.n_heads * cfg.qk_nope_dim)
    want = dict(sharding.leaves(params))
    got = dict(sharding.leaves(model.init_params(cfg, seed=0, device="cpu")))
    assert set(got) == set(want)
    for path, t in got.items():
        assert t.shape == want[path].shape and t.dtype == want[path].dtype, \
            path
        if path[-1] == "scale":
            torch.testing.assert_close(t, want[path], rtol=0, atol=0)


def test_forward_logits(arch):
    ref_cfg, ref_params, cfg, params = arch
    toks = _tokens(cfg, 2, 13, seed=1)
    ref_logits, _ = ref_model.forward(ref_cfg, ref_params, jnp.asarray(toks))
    before = FLASH.launches
    _close(model.forward(cfg, params, _t(toks)), ref_logits)
    assert FLASH.launches == before            # the plain version on CPU


@pytest.mark.parametrize("s", [3, 13])
def test_bulk_prefill_cache_and_logits(arch, s):
    ref_cfg, ref_params, cfg, params = arch
    toks = _tokens(cfg, 2, s, seed=2)
    ref_cache, ref_logits = ref_prefill.prefill(ref_cfg, ref_params,
                                                jnp.asarray(toks),
                                                cache_len=16)
    cache, logits = prefill.prefill(cfg, params, _t(toks), cache_len=16)
    assert set(cache) == set(ref_cache) == set(CACHE)
    assert cache["ckv"].shape == (2, 2, 16, cfg.kv_lora_rank)
    assert cache["krope"].shape == (2, 2, 16, cfg.qk_rope_dim)
    _close(logits, ref_logits, "logits")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)


def test_chunked_prefill_sequence(arch):
    """A ragged cut (5, 5, 3): the carry after each chunk and its logits
    match the reference's chunks; the finished cache is the reference's
    and the bulk cache."""
    ref_cfg, ref_params, cfg, params = arch
    s = 13
    toks = _tokens(cfg, 1, s, seed=3)
    cuts = prefill.prefill_chunk_cuts(s, chunk_len=5)
    assert cuts == [(0, 5), (5, 10), (10, 13)]
    assert prefill.chunk_support(cfg) == (True, "")
    ref_scr = ref_prefill.init_prefill_scratch(ref_cfg, 1, s)
    scr = prefill.init_prefill_scratch(cfg, 1, s, "cpu")
    assert set(scr) == set(ref_scr) == set(CARRY)
    for lo, hi in cuts:
        ref_scr, ref_logits = ref_prefill.prefill_chunk(
            ref_cfg, ref_params, ref_scr, jnp.asarray(toks[:, lo:hi]), lo)
        scr, logits = prefill.prefill_chunk(cfg, params, scr,
                                            _t(toks[:, lo:hi]), lo)
        _close(logits, ref_logits, f"chunk logits at {lo}")
        for k in CARRY:
            _close(scr[k], ref_scr[k], f"{k} after chunk {lo}")
    ref_cache = ref_prefill.scratch_to_cache(ref_cfg, ref_scr, cache_len=16)
    cache = prefill.scratch_to_cache(cfg, scr, cache_len=16)
    assert set(cache) == set(ref_cache) == set(CACHE)
    bulk, bulk_logits = prefill.prefill(cfg, params, _t(toks), cache_len=16)
    _close(logits, bulk_logits.numpy(), "chunked vs bulk logits")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)
        _close(cache[k], bulk[k].numpy(), f"chunked vs bulk {k}")


def test_decode_steps_at_mixed_positions(arch):
    """A batch-2 cache whose rows were prefilled to 5 and 9 tokens,
    written row by row with ``slot_write``, decoded for 4 steps (the
    shorter row's ring of 12 slots wraps on neither)."""
    ref_cfg, ref_params, cfg, params = arch
    lens, cap = (5, 9), 12
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
        row, _ = prefill.prefill(cfg, params, _t(toks), cache_len=cap)
        slot_write(cache, row, i)
    for k in CACHE:
        _close(cache[k], ref_cache[k], f"written {k}")
    feed = _tokens(cfg, 4, 2, seed=20)
    before = FLASH.launches
    for step in range(4):
        ref_cache, ref_logits = _ref_decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(feed[step]))
        cache, logits = decode.decode_step(cfg, params, cache,
                                           _t(feed[step]))
        _close(logits, ref_logits, f"decode logits step {step}")
    assert FLASH.launches == before                 # no kernel in decode
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)


def test_slot_write_touches_only_its_row(arch):
    _, _, cfg, params = arch
    cache = decode.init_cache(cfg, 3, 16, "cpu")
    assert not decode.supports_paged(cfg)
    gen = torch.Generator().manual_seed(0)
    for k in ("ckv", "krope"):
        cache[k].copy_(torch.randn(cache[k].shape, generator=gen))
    cache["pos"].copy_(torch.tensor([3, 4, 5]))
    cache["slot_pos"].copy_(torch.arange(48).view(3, 16))
    before = {k: v.clone() for k, v in cache.items()}
    row, _ = prefill.prefill(cfg, params, _t(_tokens(cfg, 1, 7, 40)),
                             cache_len=16)
    slot_write(cache, row, 1)
    for k in CACHE:
        axis = 0 if k in ("pos", "slot_pos") else 1
        for i in (0, 2):
            assert torch.equal(cache[k].select(axis, i),
                               before[k].select(axis, i)), (k, i)
        assert torch.equal(cache[k].select(axis, 1),
                           row[k].select(axis, 0).to(cache[k].dtype)), k


# ---------------------------------------------------------------------------
# the server, and what is not ported
# ---------------------------------------------------------------------------

SRV = dict(max_batch=2, max_seq=32, max_new_tokens=5)
MODES = {"chunked": dict(prefill_chunk=4), "bulk": dict(prefill_chunk=None)}


def _std03_params(cfg, seed=0):
    """The reference's parameter shapes drawn with numpy: std 0.3
    matrices, norm scales 1 + N(0, 0.1) (at the 0.02 init every request
    repeats one token)."""
    shapes = jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=VARIANTS)
def served(request):
    """Three requests of 8 tokens, one arrival every 2 steps; the
    reference server's tokens in each mode."""
    ref_cfg, cfg = _configs(request.param)
    np_params = _std03_params(ref_cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=8) for _ in range(3)]
    mesh = make_host_mesh(1, 1)
    ref_params = jax.tree.map(jnp.asarray, np_params)
    want = {}
    for mode, extra in MODES.items():
        srv = ref_server.Server(ref_cfg, ref_params, mesh,
                                srv=ref_server.ServerConfig(**SRV, **extra))
        ref_server.drive_arrivals(srv, prompts, 2)
        want[mode] = {r.rid: list(r.out_tokens) for r in srv.done}
    return cfg, params_from_reference(np_params), prompts, want


@pytest.mark.parametrize("mode", list(MODES))
def test_tokens_equal_reference_server(served, mode):
    cfg, params, prompts, want = served
    srv = server.Server(cfg, params, server.ServerConfig(**SRV,
                                                         **MODES[mode]),
                        device="cpu")
    server.drive_arrivals(srv, prompts, 2)
    got = {r.rid: list(r.out_tokens) for r in srv.done}
    assert got == want[mode]
    assert len(got) == 3 and all(len(t) == 5 for t in got.values())
    assert len({tuple(t) for t in got.values()}) > 1
    st = srv.stats()
    assert st["admission_mode"] == ("chunked(4)" if mode == "chunked"
                                    else "bulk")
    assert st["prefill_chunks"] == (6 if mode == "chunked" else 3)


def test_paged_raises(served):
    cfg, params, _, _ = served
    with pytest.raises(ValueError, match="paged"):
        server.Server(cfg, params, server.ServerConfig(
            **SRV, paged=True, block_size=4), device="cpu")
    with pytest.raises(ValueError, match="paged"):
        decode.init_paged_cache(cfg, 2, 32, 4, 8, "cpu")


def test_train_step_raises_naming_the_roadmap():
    """MLA trains at tp 1 (its attention through blockwise attention; the
    parity with the reference's step is ``test_torch_train_families.py``)
    and at tp 2 on the reference's GSPMD path, whatever the policy names
    (the reference's ART runner skips MLA): ``models/tp_block.py``, held
    to the reference's step in ``test_torch_tp_xla.py``.  The name is
    kept from when tp 2 raised."""
    from repro_torch.dist.group import Group
    from repro_torch.dist.steps import (
        StepConfig,
        TransportPolicy,
        build_train_step,
        tp_scheme,
    )

    for tp in ("xla", "fused"):
        scfg = StepConfig(seq_chunk=8, warmup_steps=1,
                          transport=TransportPolicy(tp=tp))
        for cfg in (get_config(ARCH).reduced(), get_config(ARCH)):
            assert callable(build_train_step(
                cfg, Group(rank=0, size=1, device=torch.device("cpu")),
                scfg))
            assert tp_scheme(cfg, scfg, 2) == "xla"
            assert callable(build_train_step(
                cfg, Group(rank=0, size=2, device=torch.device("cpu")),
                scfg))
