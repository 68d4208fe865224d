"""The port's mamba2 serving path against the reference, on reduced
``mamba2-2.7b`` in fp32: forward logits, bulk prefill, chunked prefill
with the constant-size state carry, and decode steps at mixed per-row
positions.

The reference's parameters cross to the port through
``repro_torch.bridge``; token inputs are numpy arrays from a seed.  fp32
tolerance 1e-5: the reference scans with ``ssd_jnp`` and the port with the
SSD kernel's plain version, which sum in another order, and XLA and
PyTorch order the GEMM and conv sums differently too.
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
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.dist.steps import slot_write
from repro_torch.models import decode, model, prefill

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "mamba2-2.7b"
STATE = ("ssm_state", "conv_state", "pos")


def _close(ours, ref, msg=""):
    np.testing.assert_allclose(ours.detach().cpu().numpy(), np.asarray(ref),
                               err_msg=msg, **TOL)


@pytest.fixture(scope="module")
def arch():
    """(ref cfg, ref params, port cfg, port params): one reference init
    shared by every test of the module."""
    ref_cfg = ref_get_config(ARCH).reduced()
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, ref_params)
    return (ref_cfg, ref_params, get_config(ARCH).reduced(),
            params_from_reference(np_params))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_bridge_counts_ssm_layers(arch):
    _, ref_params, cfg, params = arch
    assert len(params["layers"]) == cfg.n_layers == 2
    assert set(params["layers"][0]) == {"ln", "mamba"}
    assert model.count_params(params) == model.count_params_analytic(cfg)


@pytest.mark.parametrize("name", ["smollm-360m", "h2o-danube-1.8b", ARCH])
def test_count_params_analytic_matches_reference(name):
    for cfg, ref in ((get_config(name), ref_get_config(name)),
                     (get_config(name).reduced(),
                      ref_get_config(name).reduced())):
        assert model.count_params_analytic(cfg) == \
            ref_model.count_params_analytic(ref)
    cfg = get_config(name).reduced()
    assert model.count_params(model.init_params(cfg, 0, "cpu")) == \
        model.count_params_analytic(cfg)


def test_init_params_follow_reference_distributions(arch):
    """The fixed parts of ``init_mamba2`` are the reference's values."""
    _, _, cfg, params = arch
    ours = model.init_params(cfg, seed=0, device="cpu")["layers"][0]["mamba"]
    ref = params["layers"][0]["mamba"]
    for k in ("a_log", "dt_bias", "d_skip", "conv_b"):
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0)
        assert ours[k].dtype == ref[k].dtype
    for k in ("in_proj", "conv_w", "out_proj"):
        assert ours[k].shape == ref[k].shape and ours[k].dtype == ref[k].dtype
    assert abs(ours["conv_w"].std().item() / 0.1 - 0.88) < 0.1  # ±2σ cut


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
    assert set(cache) == set(ref_cache) == set(STATE)
    _close(logits, ref_logits, "logits")
    for k in STATE:
        _close(cache[k], ref_cache[k], k)


def test_chunked_prefill_sequence(arch):
    """Cuts on ``ssm_chunk`` (8) multiples; the carry after each chunk and
    the finished cache match the reference's."""
    ref_cfg, ref_params, cfg, params = arch
    s = 21
    toks = _tokens(cfg, 1, s, seed=3)
    cuts = prefill.prefill_chunk_cuts(s, chunk_len=4, multiple=cfg.ssm_chunk)
    assert cuts == ref_prefill.prefill_chunk_cuts(
        s, chunk_len=4, multiple=ref_cfg.ssm_chunk) == [(0, 8), (8, 16),
                                                       (16, 21)]
    ref_scr = ref_prefill.init_prefill_scratch(ref_cfg, 1, s)
    scr = prefill.init_prefill_scratch(cfg, 1, s, "cpu")
    for lo, hi in cuts:
        ref_scr, ref_logits = ref_prefill.prefill_chunk(
            ref_cfg, ref_params, ref_scr, jnp.asarray(toks[:, lo:hi]), lo)
        scr, logits = prefill.prefill_chunk(
            cfg, params, scr, torch.from_numpy(toks[:, lo:hi]).long(), lo)
        _close(logits, ref_logits, f"chunk logits at {lo}")
        for k in STATE:
            _close(scr[k], ref_scr[k], f"{k} after chunk {lo}")
    ref_cache = ref_prefill.scratch_to_cache(ref_cfg, ref_scr)
    cache = prefill.scratch_to_cache(cfg, scr)
    for k in STATE:
        _close(cache[k], ref_cache[k], k)
    # and the chunked carry is the bulk cache (to the fp32 tolerance: the
    # GEMMs run at other row counts, as the reference's do)
    bulk, _ = prefill.prefill(cfg, params, torch.from_numpy(toks).long())
    for k in STATE:
        _close(cache[k], bulk[k].numpy(), f"chunked vs bulk {k}")


def test_decode_steps_at_mixed_positions(arch):
    """A batch-2 cache whose rows were prefilled to different lengths,
    written row by row with ``slot_write``, decoded for 4 steps."""
    ref_cfg, ref_params, cfg, params = arch
    lens = (5, 9)
    ref_rows = [ref_prefill.prefill(ref_cfg, ref_params,
                                    jnp.asarray(_tokens(cfg, 1, n, 10 + n)))[0]
                for n in lens]
    ref_cache = {k: jnp.concatenate([r[k] for r in ref_rows],
                                    axis=0 if k == "pos" else 1)
                 for k in ref_rows[0]}
    cache = decode.init_cache(cfg, 2, 64, "cpu")
    for i, n in enumerate(lens):
        row, _ = prefill.prefill(
            cfg, params, torch.from_numpy(_tokens(cfg, 1, n, 10 + n)).long())
        slot_write(cache, row, i)
    feed = _tokens(cfg, 4, 2, seed=20)
    for step in range(4):
        ref_cache, ref_logits = ref_decode.decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(feed[step]))
        cache, logits = decode.decode_step(
            cfg, params, cache, torch.from_numpy(feed[step]).long())
        _close(logits, ref_logits, f"decode logits step {step}")
    for k in STATE:
        _close(cache[k], ref_cache[k], k)


def test_slot_write_touches_only_its_row(arch):
    _, _, cfg, params = arch
    cache = decode.init_cache(cfg, 3, 64, "cpu")
    assert not decode.supports_paged(cfg)
    gen = torch.Generator().manual_seed(0)
    for k in ("ssm_state", "conv_state"):
        cache[k].copy_(torch.randn(cache[k].shape, generator=gen))
    cache["pos"].copy_(torch.tensor([3, 4, 5]))
    before = {k: v.clone() for k, v in cache.items()}
    row, _ = prefill.prefill(cfg, params,
                             torch.from_numpy(_tokens(cfg, 1, 7, 40)).long())
    slot_write(cache, row, 1)
    for k, axis in (("ssm_state", 1), ("conv_state", 1), ("pos", 0)):
        for i in (0, 2):
            assert torch.equal(cache[k].select(axis, i),
                               before[k].select(axis, i)), (k, i)
        assert torch.equal(cache[k].select(axis, 1),
                           row[k].select(axis, 0).to(cache[k].dtype)), k
