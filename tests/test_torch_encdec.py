"""The port's encoder-decoder (``whisper-tiny``: a bidirectional encoder
over frame embeddings, a decoder with learned positions and
cross-attention) against the reference, on reduced ``whisper-tiny`` in
fp32 (2 encoder and 2 decoder layers with LayerNorm, 4/2 heads at hd 16,
16 frames of width 32): the encoder, forward logits and ``loss_fn``, bulk
prefill, chunked prefill (the encoder once on chunk 0, cross K/V reused
after), decode steps at mixed per-row positions, and token identity with
the reference ``Server`` (chunked and bulk; the encoder-decoder has no
paged layout).  Decoder prompts longer than the 16 encoder rows put more
q rows than K/V rows into the unmasked cross-attention.

The reference's parameters cross to the port through
``repro_torch.bridge``; tokens and frames are numpy arrays from a seed.
fp32 tolerance 1e-5 against the reference; chunked against bulk 1e-5
too, never bitwise (ROADMAP §3).
"""

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
from repro_torch.models import decode, model, prefill
from repro_torch.runtime import server

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "whisper-tiny"
CACHE = ("k", "v", "cross_k", "cross_v", "slot_pos", "pos")
CARRY = ("k", "v", "cross_k", "cross_v", "pos")
_ref_decode_step = jax.jit(ref_decode.decode_step, static_argnums=0)


def _close(ours, ref, msg=""):
    np.testing.assert_allclose(ours.detach().cpu().numpy(), np.asarray(ref),
                               err_msg=msg, **TOL)


@pytest.fixture(scope="module")
def arch():
    """(ref cfg, ref params, port cfg, port params): one reference init
    shared by the module's parity tests."""
    ref_cfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    return (ref_cfg, ref_params, cfg,
            params_from_reference(jax.tree.map(np.asarray, ref_params)))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.frontend_dim), dtype=np.float32)


def _t(a):
    return torch.from_numpy(a).long() if a.dtype == np.int32 \
        else torch.from_numpy(a)


def test_bridge_params_and_count(arch):
    """Encoder and decoder stacks as per-layer lists, LayerNorms with
    their bias, the learned decoder positions; the analytic count is the
    reference's (full and reduced) and the drawn init has its shapes."""
    _, ref_params, cfg, params = arch
    assert len(params["enc_layers"]) == cfg.n_encoder_layers == 2
    assert len(params["dec_layers"]) == cfg.n_layers == 2
    assert set(params["dec_layers"][1]) == {"ln1", "attn", "ln2", "mlp",
                                            "ln_x", "xattn"}
    assert set(params["enc_norm"]) == {"scale", "bias"}
    assert params["dec_pos"].shape == (model.DEC_POS, cfg.d_model)
    np.testing.assert_array_equal(
        params["dec_layers"][1]["xattn"]["wk"].numpy(),
        np.asarray(ref_params["dec_layers"]["xattn"]["wk"][1]))
    assert model.count_params(params) == model.count_params_analytic(cfg)
    full, ref_full = get_config(ARCH), ref_get_config(ARCH)
    assert model.count_params_analytic(full) == \
        ref_model.count_params_analytic(ref_full)
    drawn = model.init_params(cfg, seed=0, device="cpu")
    assert model.count_params(drawn) == model.count_params(params)
    assert torch.equal(drawn["dec_layers"][0]["ln_x"]["bias"],
                       torch.zeros(cfg.d_model))


def test_encode(arch):
    ref_cfg, ref_params, cfg, params = arch
    fe = _frames(cfg, 2, seed=1)
    _close(model.encode(cfg, params, _t(fe)),
           ref_model.encode(ref_cfg, ref_params, jnp.asarray(fe)), "encode")


def test_forward_and_loss(arch):
    ref_cfg, ref_params, cfg, params = arch
    toks, fe = _tokens(cfg, 2, 21, seed=2), _frames(cfg, 2, seed=3)
    ref_logits, _ = ref_model.forward(ref_cfg, ref_params, jnp.asarray(toks),
                                      jnp.asarray(fe))
    logits = model.forward(cfg, params, _t(toks), _t(fe))
    assert logits.shape == (2, 21, cfg.vocab_size)
    _close(logits, ref_logits, "forward")
    labels = _tokens(cfg, 2, 21, seed=4)
    labels[1, 5:] = -1
    ref_total, ref_m = ref_model.loss_fn(
        ref_cfg, ref_params, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels),
                              "frontend_embeds": jnp.asarray(fe)})
    total, m = model.loss_fn(cfg, params, {"tokens": _t(toks),
                                           "labels": _t(labels),
                                           "frontend_embeds": _t(fe)})
    _close(total, ref_total, "loss")
    for k in ("ce", "z_loss", "tokens"):
        _close(m[k], ref_m[k], k)


@pytest.mark.parametrize("s", [5, 20])
def test_bulk_prefill_cache_and_logits(arch, s):
    """S 20 puts 20 decoder rows against the 16 encoder rows."""
    ref_cfg, ref_params, cfg, params = arch
    toks, fe = _tokens(cfg, 2, s, seed=5), _frames(cfg, 2, seed=6)
    ref_cache, ref_logits = ref_prefill.prefill(
        ref_cfg, ref_params, jnp.asarray(toks), jnp.asarray(fe), cache_len=32)
    cache, logits = prefill.prefill(cfg, params, _t(toks), _t(fe),
                                    cache_len=32)
    assert set(cache) == set(ref_cache) == set(CACHE)
    assert cache["cross_k"].shape == (2, 2, cfg.n_kv_heads, 16, 16)
    _close(logits, ref_logits, "logits")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)


def test_chunked_prefill_encoder_once(arch):
    """Cuts at 3 and 21 (an 18-row chunk, more rows than the encoder's
    16): the frames go to chunk 0 alone; the carry after each chunk and
    the finished cache match the reference's, and the chunked cache is
    the bulk cache."""
    ref_cfg, ref_params, cfg, params = arch
    s = 30
    toks, fe = _tokens(cfg, 1, s, seed=7), _frames(cfg, 1, seed=8)
    assert prefill.chunk_support(cfg) == (True, "")
    ref_scr = ref_prefill.init_prefill_scratch(ref_cfg, 1, s)
    scr = prefill.init_prefill_scratch(cfg, 1, s, "cpu")
    assert set(scr) == set(ref_scr) == set(CARRY)
    for lo, hi in ((0, 3), (3, 21), (21, s)):
        f = fe if lo == 0 else None
        ref_scr, ref_logits = ref_prefill.prefill_chunk(
            ref_cfg, ref_params, ref_scr, jnp.asarray(toks[:, lo:hi]), lo,
            None if f is None else jnp.asarray(f))
        scr, logits = prefill.prefill_chunk(
            cfg, params, scr, _t(toks[:, lo:hi]), lo,
            None if f is None else _t(f))
        _close(logits, ref_logits, f"chunk logits at {lo}")
        for k in CARRY:
            _close(scr[k], ref_scr[k], f"{k} after chunk {lo}")
    ref_cache = ref_prefill.scratch_to_cache(ref_cfg, ref_scr, cache_len=32)
    cache = prefill.scratch_to_cache(cfg, scr, cache_len=32)
    bulk, bulk_logits = prefill.prefill(cfg, params, _t(toks), _t(fe),
                                        cache_len=32)
    _close(logits, bulk_logits.numpy(), "chunked vs bulk logits")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)
        _close(cache[k], bulk[k].numpy(), f"chunked vs bulk {k}")
    with pytest.raises(ValueError, match="frames"):
        prefill.prefill_chunk(cfg, params,
                              prefill.init_prefill_scratch(cfg, 1, s, "cpu"),
                              _t(toks[:, :3]), 0)


def test_decode_steps_at_mixed_positions(arch):
    """A batch-2 cache prefilled to 4 and 11 tokens (each row its own
    frames), decoded for 4 steps: no rope, ``dec_pos`` at each row's
    position, cross-attention over each row's encoder rows."""
    ref_cfg, ref_params, cfg, params = arch
    cap = 32
    ref_cache = ref_decode.init_cache(ref_cfg, 2, cap)
    cache = decode.init_cache(cfg, 2, cap, "cpu")
    assert set(cache) == set(ref_cache) == set(CACHE)
    assert not decode.supports_paged(cfg)
    for i, n in enumerate((4, 11)):
        toks, fe = _tokens(cfg, 1, n, 10 + n), _frames(cfg, 1, 20 + n)
        ref_row, _ = ref_prefill.prefill(ref_cfg, ref_params,
                                         jnp.asarray(toks), jnp.asarray(fe),
                                         cache_len=cap)
        ref_cache = {k: (v.at[i].set(ref_row[k][0]) if k in ("pos",
                                                            "slot_pos")
                         else v.at[:, i].set(ref_row[k][:, 0]))
                     for k, v in ref_cache.items()}
        row, _ = prefill.prefill(cfg, params, _t(toks), _t(fe),
                                 cache_len=cap)
        slot_write(cache, row, i)
    feed = _tokens(cfg, 4, 2, seed=40)
    for step in range(4):
        ref_cache, ref_logits = _ref_decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(feed[step]))
        cache, logits = decode.decode_step(cfg, params, cache,
                                           _t(feed[step]))
        _close(logits, ref_logits, f"decode logits step {step}")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)


def test_decoder_ring_capped():
    cfg = get_config(ARCH)
    assert decode.kv_buf_len(cfg, 10_000) == decode.ENCDEC_DECODER_CAP
    assert decode.kv_buf_len(cfg, 448) == 448


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

SRV = dict(max_batch=2, max_seq=32, max_new_tokens=5)
MODES = {"chunked": dict(prefill_chunk=4), "bulk": dict(prefill_chunk=None)}


def _std03_params(cfg, seed=0):
    """The reference's parameter shapes drawn with numpy: std 0.3
    matrices and biases, norm scales 1 + N(0, 0.1) (at the 0.02 init
    every request repeats one token)."""
    shapes = jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def served():
    """Three requests of 9 decoder tokens and 16 frames, one arrival every
    2 steps; the reference's tokens in each mode."""
    ref_cfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    np_params = _std03_params(ref_cfg)
    rng = np.random.default_rng(0)
    items = [(rng.integers(0, cfg.vocab_size, size=9),
              rng.standard_normal((cfg.frontend_tokens, cfg.frontend_dim),
                                  dtype=np.float32)) for _ in range(3)]
    mesh = make_host_mesh(1, 1)
    ref_params = jax.tree.map(jnp.asarray, np_params)
    want = {}
    for mode, extra in MODES.items():
        srv = ref_server.Server(ref_cfg, ref_params, mesh,
                                srv=ref_server.ServerConfig(**SRV, **extra))
        ref_server.drive_arrivals(srv, items, 2)
        want[mode] = {r.rid: list(r.out_tokens) for r in srv.done}
    return cfg, params_from_reference(np_params), items, want


@pytest.mark.parametrize("mode", list(MODES))
def test_tokens_equal_reference_server(served, mode):
    cfg, params, items, want = served
    srv = server.Server(cfg, params, server.ServerConfig(**SRV,
                                                         **MODES[mode]),
                        device="cpu")
    server.drive_arrivals(srv, items, 2)
    got = {r.rid: list(r.out_tokens) for r in srv.done}
    assert got == want[mode]
    assert len(got) == 3
    assert srv.stats()["prefill_chunks"] == (9 if mode == "chunked" else 3)
    assert want["chunked"] == want["bulk"]


def test_submit_checks(served):
    cfg, params, items, _ = served
    srv = server.Server(cfg, params, server.ServerConfig(**SRV),
                        device="cpu")
    with pytest.raises(ValueError, match="frontend"):
        srv.submit(items[0][0])
    wide = server.Server(cfg, params, server.ServerConfig(
        **dict(SRV, max_seq=64)), device="cpu")
    with pytest.raises(ValueError, match="decoder"):
        wide.submit(np.zeros(cfg.decoder_max_seq + 1, np.int32), items[0][1])
    with pytest.raises(ValueError, match="paged"):
        server.Server(cfg, params, server.ServerConfig(
            **SRV, paged=True, block_size=4), device="cpu")
