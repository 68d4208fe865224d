"""The port's dense decoder against the reference, layer by layer of the
serving path: forward logits, bulk prefill, chunked prefill, and decode
steps at mixed per-row positions.

The reference's parameters (``repro.models.model.init_params``) cross to
the port through ``repro_torch.bridge``; token inputs are numpy arrays
from a seed.  fp32 tolerance 1e-5: the reference attends through its
blockwise jnp path and the port through the flash kernel's plain version,
which sum in a different order, and XLA and PyTorch order the GEMM sums
differently too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import decode as ref_decode
from repro.models import model as ref_model
from repro.models import prefill as ref_prefill
from repro_torch.bridge import params_from_reference, to_tensor
from repro_torch.configs import get_config
from repro_torch.models import decode, model, prefill

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["smollm-360m", "h2o-danube-1.8b"]
CACHE_LEN = 16            # h2o-danube's reduced window (8) caps its ring


def _close(ours, ref, msg=""):
    np.testing.assert_allclose(ours.detach().cpu().numpy(), np.asarray(ref),
                               err_msg=msg, **TOL)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(ref cfg, ref params, port cfg, port params) — one reference init
    per arch, shared by every test of the module."""
    ref_cfg = ref_get_config(request.param).reduced()
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, ref_params)
    return (ref_cfg, ref_params, get_config(request.param).reduced(),
            params_from_reference(np_params))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_bridge_is_bit_exact_for_bf16():
    import ml_dtypes

    a = np.random.default_rng(0).standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)
    t = to_tensor(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))


def test_forward_logits(arch):
    ref_cfg, ref_params, cfg, params = arch
    toks = _tokens(cfg, 2, 13, seed=1)
    ref_logits, _ = ref_model.forward(ref_cfg, ref_params, jnp.asarray(toks))
    _close(model.forward(cfg, params, torch.from_numpy(toks).long()),
           ref_logits)


def test_bulk_prefill_cache_and_logits(arch):
    """S = 13 > the reduced window: the h2o-danube ring wraps."""
    ref_cfg, ref_params, cfg, params = arch
    toks = _tokens(cfg, 2, 13, seed=2)
    ref_cache, ref_logits = ref_prefill.prefill(
        ref_cfg, ref_params, jnp.asarray(toks), cache_len=CACHE_LEN)
    cache, logits = prefill.prefill(cfg, params, torch.from_numpy(toks).long(),
                                    cache_len=CACHE_LEN)
    _close(logits, ref_logits, "logits")
    for k in ("k", "v", "slot_pos", "pos"):
        _close(cache[k], ref_cache[k], k)


def test_chunked_prefill_sequence(arch):
    ref_cfg, ref_params, cfg, params = arch
    s = 11
    toks = _tokens(cfg, 1, s, seed=3)
    cuts = prefill.prefill_chunk_cuts(s, chunk_len=4)
    assert cuts == ref_prefill.prefill_chunk_cuts(s, chunk_len=4)
    ref_scr = ref_prefill.init_prefill_scratch(ref_cfg, 1, s)
    scr = prefill.init_prefill_scratch(cfg, 1, s, "cpu")
    for lo, hi in cuts:
        ref_scr, ref_logits = ref_prefill.prefill_chunk(
            ref_cfg, ref_params, ref_scr, jnp.asarray(toks[:, lo:hi]), lo)
        scr, logits = prefill.prefill_chunk(
            cfg, params, scr, torch.from_numpy(toks[:, lo:hi]).long(), lo)
        _close(logits, ref_logits, f"chunk logits at {lo}")
        _close(scr["k"], ref_scr["k"], f"scratch k after chunk {lo}")
    ref_cache = ref_prefill.scratch_to_cache(ref_cfg, ref_scr,
                                             cache_len=CACHE_LEN)
    cache = prefill.scratch_to_cache(cfg, scr, cache_len=CACHE_LEN)
    for k in ("k", "v", "slot_pos", "pos"):
        _close(cache[k], ref_cache[k], k)
    # and the paged view of that cache is a pure reshape of it
    bk, bv, sp, pos = prefill.cache_to_blocks(cfg, cache, 4)
    rbk, rbv, rsp, rpos = ref_prefill.cache_to_blocks(ref_cfg, ref_cache, 4)
    _close(bk, rbk, "blocks k")
    _close(sp, rsp, "slot_pos row")


def test_decode_steps_at_mixed_positions(arch):
    """A batch-2 cache whose rows were prefilled to different lengths, so
    every decode step runs its rows at different positions."""
    ref_cfg, ref_params, cfg, params = arch
    lens = (5, 9)
    ref_rows = [ref_prefill.prefill(ref_cfg, ref_params,
                                    jnp.asarray(_tokens(cfg, 1, n, 10 + n)),
                                    cache_len=CACHE_LEN)[0] for n in lens]
    rows = [prefill.prefill(cfg, params,
                            torch.from_numpy(_tokens(cfg, 1, n, 10 + n)).long(),
                            cache_len=CACHE_LEN)[0] for n in lens]
    ref_cache = {k: jnp.concatenate([r[k] for r in ref_rows],
                                    axis=1 if k in ("k", "v") else 0)
                 for k in ref_rows[0]}
    cache = {k: torch.cat([r[k] for r in rows], dim=1 if k in ("k", "v")
                          else 0) for k in rows[0]}
    feed = _tokens(cfg, 4, 2, seed=20)
    for step in range(4):
        ref_cache, ref_logits = ref_decode.decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(feed[step]))
        cache, logits = decode.decode_step(
            cfg, params, cache, torch.from_numpy(feed[step]).long())
        _close(logits, ref_logits, f"decode logits step {step}")
    for k in ("k", "v", "slot_pos", "pos"):
        _close(cache[k], ref_cache[k], k)


def test_paged_decode_equals_contiguous(arch):
    """Decode through block tables gives the contiguous ring's values."""
    _, _, cfg, params = arch
    toks = torch.from_numpy(_tokens(cfg, 1, 7, seed=30)).long()
    slot, _ = prefill.prefill(cfg, params, toks, cache_len=CACHE_LEN)
    contiguous = decode.init_cache(cfg, 2, CACHE_LEN, "cpu")
    paged = decode.init_paged_cache(cfg, 2, CACHE_LEN, 4, 12, "cpu")
    from repro_torch.dist.steps import block_write, slot_write

    slot_write(contiguous, slot, 1)
    bk, bv, sp, pos = prefill.cache_to_blocks(cfg, slot, 4)
    table = torch.arange(2, 2 + bk.shape[1], dtype=torch.int32)
    block_write(paged, bk, bv, table, table, sp, pos, 1)
    feed = _tokens(cfg, 5, 2, seed=31)
    for step in range(5):
        t = torch.from_numpy(feed[step]).long()
        contiguous, lc = decode.decode_step(cfg, params, contiguous, t)
        paged, lp = decode.decode_step(cfg, params, paged, t)
        torch.testing.assert_close(lp[1], lc[1], rtol=0, atol=0)
    view = decode.gather_blocks(paged["kp"][0], paged["block_ids"])
    torch.testing.assert_close(view[1], contiguous["k"][0, 1], rtol=0, atol=0)


def test_nemotron_reduced_forward():
    """nemotron-4-340b (relu² MLP, not gated), held at ``reduced()``:
    forward logits against the reference's from the same parameters."""
    ref_cfg = ref_get_config("nemotron-4-340b").reduced()
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(1))
    cfg = get_config("nemotron-4-340b").reduced()
    params = params_from_reference(jax.tree.map(np.asarray, ref_params))
    assert (cfg.activation, cfg.gated_mlp) == ("relu2", False)
    assert model.count_params(params) == model.count_params_analytic(cfg)
    assert model.count_params_analytic(get_config("nemotron-4-340b")) == \
        ref_model.count_params_analytic(ref_get_config("nemotron-4-340b"))
    toks = _tokens(cfg, 2, 11, seed=9)
    ref_logits, _ = ref_model.forward(ref_cfg, ref_params, jnp.asarray(toks))
    _close(model.forward(cfg, params, torch.from_numpy(toks).long()),
           ref_logits)
