"""The port's VLM (``internvl2-2b``: projected patch embeddings before the
text) against the reference, on reduced ``internvl2-2b`` in fp32 (2
layers, 4/2 heads at hd 16, 8 patch rows of width 32): forward logits
and ``loss_fn`` (its crop of the patch positions), bulk prefill, chunked
prefill over cuts inside the patch rows and across their edge, decode
steps at mixed per-row positions, and token identity with the reference
``Server`` (contiguous and paged).  A paged server must not share prefix
blocks between requests whose text agrees but whose patches differ.

The reference's parameters cross to the port through
``repro_torch.bridge``; tokens and patch embeddings are numpy arrays from
a seed.  fp32 tolerance 1e-5 against the reference (it attends blockwise,
the port through the flash kernel's plain version: the sums run in other
orders); chunked against bulk 1e-5 too, never bitwise (ROADMAP §3).
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
ARCH = "internvl2-2b"
CACHE = ("k", "v", "slot_pos", "pos")
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


def _patches(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.frontend_dim), dtype=np.float32)


def _t(a):
    return torch.from_numpy(a).long() if a.dtype == np.int32 \
        else torch.from_numpy(a)


def test_params_and_count(arch):
    _, ref_params, cfg, params = arch
    assert (cfg.frontend_tokens, cfg.frontend_dim) == (8, 32)
    assert params["frontend_proj"].shape == (32, cfg.d_model)
    np.testing.assert_array_equal(params["frontend_proj"].numpy(),
                                  np.asarray(ref_params["frontend_proj"]))
    assert model.count_params(params) == model.count_params_analytic(cfg)
    full, ref_full = get_config(ARCH), ref_get_config(ARCH)
    assert model.count_params_analytic(full) == \
        ref_model.count_params_analytic(ref_full)
    drawn = model.init_params(cfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in drawn.items()
            if isinstance(v, torch.Tensor)} == \
        {k: tuple(v.shape) for k, v in params.items()
         if isinstance(v, torch.Tensor)}


def test_forward_and_loss(arch):
    """Logits over patches and text (B, N + S, V), and ``loss_fn``, which
    drops the patch positions before the cross-entropy."""
    ref_cfg, ref_params, cfg, params = arch
    toks, fe = _tokens(cfg, 2, 7, seed=1), _patches(cfg, 2, seed=2)
    ref_logits, _ = ref_model.forward(ref_cfg, ref_params, jnp.asarray(toks),
                                      jnp.asarray(fe))
    logits = model.forward(cfg, params, _t(toks), _t(fe))
    assert logits.shape == (2, 8 + 7, cfg.vocab_size)
    _close(logits, ref_logits, "forward")
    labels = _tokens(cfg, 2, 7, seed=3)
    labels[0, :2] = -1
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
    with pytest.raises(ValueError, match="patch"):
        model.forward(cfg, params, _t(toks))


def test_bulk_prefill_cache_and_logits(arch):
    ref_cfg, ref_params, cfg, params = arch
    toks, fe = _tokens(cfg, 2, 9, seed=4), _patches(cfg, 2, seed=5)
    ref_cache, ref_logits = ref_prefill.prefill(
        ref_cfg, ref_params, jnp.asarray(toks), jnp.asarray(fe), cache_len=32)
    cache, logits = prefill.prefill(cfg, params, _t(toks), _t(fe),
                                    cache_len=32)
    assert set(cache) == set(ref_cache) == set(CACHE)
    assert int(cache["pos"][0]) == 8 + 9
    _close(logits, ref_logits, "logits")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)


def test_chunked_prefill_cuts_inside_the_patches(arch):
    """Rows 0–7 are patches, 8–20 text: a cut at 5 (inside the patches),
    at 11 (past their edge) and a chunk of text alone.  The carry after
    each chunk and the finished cache match the reference's, and the
    chunked cache is the bulk cache (fp32, 1e-5)."""
    ref_cfg, ref_params, cfg, params = arch
    toks, fe = _tokens(cfg, 1, 13, seed=6), _patches(cfg, 1, seed=7)
    n, s = cfg.frontend_tokens, cfg.frontend_tokens + 13
    assert prefill.chunk_support(cfg) == (True, "")
    ref_scr = ref_prefill.init_prefill_scratch(ref_cfg, 1, s)
    scr = prefill.init_prefill_scratch(cfg, 1, s, "cpu")
    assert set(scr) == set(ref_scr) == {"k", "v", "pos"}
    for lo, hi in ((0, 5), (5, 11), (11, s)):
        f = fe[:, lo:min(hi, n)] if lo < n else None
        t = toks[:, max(0, lo - n):max(0, hi - n)]
        ref_scr, ref_logits = ref_prefill.prefill_chunk(
            ref_cfg, ref_params, ref_scr, jnp.asarray(t), lo,
            None if f is None else jnp.asarray(f))
        scr, logits = prefill.prefill_chunk(
            cfg, params, scr, _t(t), lo, None if f is None else _t(f))
        assert int(scr["pos"][0]) == hi
        _close(logits, ref_logits, f"chunk logits at {lo}")
        for k in ("k", "v", "pos"):
            _close(scr[k], ref_scr[k], f"{k} after chunk {lo}")
    ref_cache = ref_prefill.scratch_to_cache(ref_cfg, ref_scr, cache_len=32)
    cache = prefill.scratch_to_cache(cfg, scr, cache_len=32)
    bulk, bulk_logits = prefill.prefill(cfg, params, _t(toks), _t(fe),
                                        cache_len=32)
    _close(logits, bulk_logits.numpy(), "chunked vs bulk logits")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)
        _close(cache[k], bulk[k].numpy(), f"chunked vs bulk {k}")


def test_decode_steps_at_mixed_positions(arch):
    """A batch-2 cache whose rows hold 8 patches and 3 or 7 tokens,
    written row by row, decoded for 4 steps (the dense decode)."""
    ref_cfg, ref_params, cfg, params = arch
    cap = 32
    ref_cache = ref_decode.init_cache(ref_cfg, 2, cap)
    cache = decode.init_cache(cfg, 2, cap, "cpu")
    assert set(cache) == set(ref_cache) == set(CACHE)
    for i, n in enumerate((3, 7)):
        toks, fe = _tokens(cfg, 1, n, 10 + n), _patches(cfg, 1, 20 + n)
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
    feed = _tokens(cfg, 4, 2, seed=30)
    for step in range(4):
        ref_cache, ref_logits = _ref_decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(feed[step]))
        cache, logits = decode.decode_step(cfg, params, cache,
                                           _t(feed[step]))
        _close(logits, ref_logits, f"decode logits step {step}")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

SRV = dict(max_batch=2, max_seq=32, max_new_tokens=5, prefill_chunk=4)
MODES = {"contiguous": {}, "paged": dict(paged=True, block_size=4)}


def _std03_params(cfg, seed=0):
    """The reference's parameter shapes drawn with numpy: std 0.3
    matrices, norm scales 1 + N(0, 0.1) (at the 0.02 init every request
    repeats one token, and token identity would prove little)."""
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
    """Three requests of 6 tokens and 8 patch rows (14 prefill rows: cuts
    at 4 inside the patches, at 8 on their edge and at 12 in the text),
    one arrival every 2 steps; the reference's tokens in each mode."""
    ref_cfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    np_params = _std03_params(ref_cfg)
    rng = np.random.default_rng(0)
    items = [(rng.integers(0, cfg.vocab_size, size=6),
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
    assert len(got) == 3 and srv.stats()["prefill_chunks"] == 3 * 4
    assert want["paged"] == want["contiguous"]


def test_paged_does_not_share_prefix_blocks_across_patches(served):
    """Two requests with the same text and different patches, the second
    admitted after the first has finished: their first blocks hold
    different patch rows, so none may come from the prefix cache; each
    decodes the tokens it decodes alone."""
    cfg, params, items, _ = served
    text = items[0][0]
    pair = [(text, items[0][1]), (text, items[1][1])]
    alone = []
    for item in pair:
        srv = server.Server(cfg, params, server.ServerConfig(**SRV),
                            device="cpu")
        srv.submit(*item)
        srv.run()
        alone.append(srv.done[0].out_tokens)
    assert alone[0] != alone[1]          # the patches decide the tokens
    srv = server.Server(cfg, params, server.ServerConfig(
        **SRV, **MODES["paged"]), device="cpu")
    for item in pair:
        srv.submit(*item)
        srv.run()
    assert srv.prefix_hits == 0
    assert [r.out_tokens for r in sorted(srv.done, key=lambda r: r.rid)] \
        == alone


def test_submit_checks_the_patches(served):
    cfg, params, items, _ = served
    srv = server.Server(cfg, params, server.ServerConfig(**SRV),
                        device="cpu")
    with pytest.raises(ValueError, match="frontend"):
        srv.submit(items[0][0])
    with pytest.raises(ValueError, match="expected"):
        srv.submit(items[0][0], items[0][1][:4])
    with pytest.raises(ValueError, match="outside"):
        srv.submit(np.zeros(SRV["max_seq"] - cfg.frontend_tokens + 1,
                            np.int32), items[0][1])
