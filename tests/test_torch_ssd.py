"""The port's SSD scan against the reference's.

The same numpy inputs go to ``repro_torch.kernels.ssd`` and to the
reference: the Pallas kernel (``repro.kernels.ssd.ssd``, interpret mode on
the CPU), the chunked jnp scan (``layers.ssd_jnp``) and the sequential
oracle (``ssd_ref``); ``ssd_split`` is the scan as the CUDA kernel splits
it (local chunk states, an ordered pass, then y).  Tolerances: fp32 1e-5
against the two chunked forms, which do the same arithmetic in another
order, and against an fp64 recurrence; the reference's own 2e-3 against
the sequential oracle; 1e-6 for the one-token decode step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.ssd import ssd as ref_ssd
from repro.kernels.ssd import ssd_decode_step as ref_decode_step
from repro.kernels.ssd import ssd_ref
from repro.models import layers as ref_layers
from repro.models.model import init_params as ref_init_params
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import (
    SSD,
    ssd,
    ssd_chunk_fed,
    ssd_decode_step,
    ssd_plain,
    ssd_sequential,
    ssd_split,
)
from repro_torch.models import layers

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(s, seed=0, b=2, h=4, p=16, g=2, n=8, init=False):
    """numpy inputs drawn as the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = dict(
        x=rng.standard_normal((b, s, h, p)).astype(f32),
        dt=np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f32),
        a=-np.exp(np.linspace(0.0, 1.0, h)).astype(f32),
        b=rng.standard_normal((b, s, g, n)).astype(f32),
        c=rng.standard_normal((b, s, g, n)).astype(f32),
        d=np.ones((h,), f32))
    state = rng.standard_normal((b, h, n, p)).astype(f32) if init else None
    return out, state


def _torch(arrs):
    return [torch.from_numpy(arrs[k]) for k in ("x", "dt", "a", "b", "c", "d")]


def _jax(arrs):
    return [jnp.asarray(arrs[k]) for k in ("x", "dt", "a", "b", "c", "d")]


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


CASES = [(64, 16, False), (50, 16, False), (128, 32, False), (17, 8, False),
         (50, 16, True)]


@pytest.mark.parametrize("s,chunk,init", CASES)
def test_plain_matches_reference_scans(s, chunk, init):
    """``ssd_plain`` against the Pallas kernel (interpret mode) and
    ``ssd_jnp`` at 1e-5, with ragged S and a carried ``init_state``."""
    arrs, st0 = _inputs(s, seed=s + chunk, init=init)
    init_state = None if st0 is None else torch.from_numpy(st0)
    y, st = ssd_plain(*_torch(arrs), chunk=chunk, init_state=init_state)
    jst0 = None if st0 is None else jnp.asarray(st0)
    yk, stk = ref_ssd(*_jax(arrs), chunk=chunk, init_state=jst0)
    yj, stj = ref_layers.ssd_jnp(*_jax(arrs), chunk=chunk, init_state=jst0)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close(y, yk)
    _close(st, stk)
    _close(y, yj)
    _close(st, stj)


#: the file's cases, plus 17 chunks (the kernel's state chain) and a
#: ragged many-chunk sequence from a carried state
SPLIT_CASES = CASES + [(136, 8, False), (203, 16, True)]


@pytest.mark.parametrize("s,chunk,init", SPLIT_CASES)
def test_split_and_plain_match_reference_scans(s, chunk, init):
    """``ssd_split`` (the kernel's decomposition) and ``ssd_plain`` against
    the Pallas kernel (interpret mode) and ``ssd_jnp`` at 1e-5, on draws of
    their own (``test_plain_matches_reference_scans`` draws s + chunk)."""
    arrs, st0 = _inputs(s, seed=10_000 + s + chunk, init=init)
    init_state = None if st0 is None else torch.from_numpy(st0)
    jst0 = None if st0 is None else jnp.asarray(st0)
    yk, stk = ref_ssd(*_jax(arrs), chunk=chunk, init_state=jst0)
    yj, stj = ref_layers.ssd_jnp(*_jax(arrs), chunk=chunk, init_state=jst0)
    for fn in (ssd_split, ssd_plain):
        y, st = fn(*_torch(arrs), chunk=chunk, init_state=init_state)
        assert y.dtype == torch.float32 and st.dtype == torch.float32
        _close(y, yk)
        _close(st, stk)
        _close(y, yj)
        _close(st, stj)


@pytest.mark.parametrize("s,chunk", [(c[0], c[1]) for c in SPLIT_CASES
                                     if not c[2]])
def test_split_matches_oracle(s, chunk):
    """``ssd_split`` against the reference's step-by-step oracle at its own
    2e-3."""
    arrs, _ = _inputs(s, seed=s + 2)
    yr, sr = ssd_ref(*_jax(arrs))
    y, st = ssd_split(*_torch(arrs), chunk=chunk)
    _close(y, yr, rtol=2e-3, atol=2e-3)
    _close(st, sr, rtol=2e-3, atol=2e-3)


def _recurrence_f64(arrs):
    """The scan's definition, one step at a time from a zero state, in
    numpy float64."""
    x, dt, a, b, c, d = (arrs[k].astype(np.float64)
                         for k in ("x", "dt", "a", "b", "c", "d"))
    hpg = x.shape[2] // b.shape[2]
    bh, ch = np.repeat(b, hpg, axis=2), np.repeat(c, hpg, axis=2)
    state = np.zeros((x.shape[0], x.shape[2], b.shape[3], x.shape[3]))
    y = np.empty_like(x)
    for t in range(x.shape[1]):
        state = (np.exp(a * dt[:, t])[..., None, None] * state
                 + (dt[:, t, :, None] * bh[:, t])[..., None]
                 * x[:, t, :, None, :])
        y[:, t] = np.einsum("bhn,bhnp->bhp", ch[:, t], state)
    return y + d[:, None] * x, state


def _share(ours, ref):
    """Largest error as a share of the file's allowance, 1e-5 + 1e-5 |ref|."""
    o, r = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(o - r) / (1e-5 + 1e-5 * np.abs(r))))


@pytest.mark.parametrize("seed", [160, 161])
def test_plain_matches_fp64_recurrence(seed):
    """At S 128, chunk 32, two fp32 forms of the scan can differ by more
    than the file's 1e-5: with seed 161 (not a case of the tests above)
    ``ssd_plain`` and the Pallas kernel do.  The fp64 recurrence is the
    witness that this is fp32 rounding on both sides: ``ssd_plain`` is
    held to it at 1e-5, and the shares of the allowance are printed
    (``-s``)."""
    arrs, _ = _inputs(128, seed=seed)
    y, st = ssd_plain(*_torch(arrs), chunk=32)
    yk, _ = ref_ssd(*_jax(arrs), chunk=32)
    y64, st64 = _recurrence_f64(arrs)
    print(f"seed {seed}: y shares of the 1e-5 allowance: ssd_plain vs "
          f"Pallas {_share(y, yk):.2f}, ssd_plain vs fp64 "
          f"{_share(y, y64):.2f}, Pallas vs fp64 {_share(yk, y64):.2f}")
    _close(y, y64)
    _close(st, st64)


@pytest.mark.parametrize("s,chunk", [(c[0], c[1]) for c in CASES[:4]])
def test_plain_and_sequential_match_oracle(s, chunk):
    """Both port forms against the reference's step-by-step oracle, at the
    reference's own 2e-3 (chunking changes the order of the sums)."""
    arrs, _ = _inputs(s, seed=s)
    yr, sr = ssd_ref(*_jax(arrs))
    y, st = ssd_plain(*_torch(arrs), chunk=chunk)
    _close(y, yr, rtol=2e-3, atol=2e-3)
    _close(st, sr, rtol=2e-3, atol=2e-3)
    ys, sts = ssd_sequential(*_torch(arrs))
    _close(ys, yr)
    _close(sts, sr)


def test_decode_step_matches_reference():
    rng = np.random.default_rng(5)
    b, h, p, g, n = 2, 4, 8, 2, 4
    f32 = np.float32
    state = rng.standard_normal((b, h, n, p)).astype(f32)
    xt = rng.standard_normal((b, h, p)).astype(f32)
    dtt = np.log1p(np.exp(rng.standard_normal((b, h)))).astype(f32)
    a = -np.exp(np.linspace(0.0, 0.5, h)).astype(f32)
    bt = rng.standard_normal((b, g, n)).astype(f32)
    ct = rng.standard_normal((b, g, n)).astype(f32)
    d = rng.standard_normal((h,)).astype(f32)
    args = (state, xt, dtt, a, bt, ct, d)
    st, y = ssd_decode_step(*(torch.from_numpy(v) for v in args))
    rst, ry = ref_decode_step(*(jnp.asarray(v) for v in args))
    _close(st, rst, rtol=1e-6, atol=1e-6)
    _close(y, ry, rtol=1e-6, atol=1e-6)


def test_resume_on_chunk_boundary_is_bitwise():
    """Seeding ``init_state`` with a head's final state continues the scan
    exactly when the cut lands on a chunk boundary."""
    arrs, _ = _inputs(32, seed=3)
    t = _torch(arrs)
    y0, st0 = ssd_plain(*t, chunk=8)
    head = [v[:, :16] if v.dim() > 1 else v for v in t]
    tail = [v[:, 16:] if v.dim() > 1 else v for v in t]
    _, st_head = ssd_plain(*head, chunk=8)
    y_tail, st_tail = ssd_plain(*tail, chunk=8, init_state=st_head)
    assert torch.equal(y0[:, 16:], y_tail)
    assert torch.equal(st0, st_tail)


def test_wrapper_takes_plain_on_cpu_and_rejects_other_devices():
    arrs, _ = _inputs(20, seed=4)
    t = _torch(arrs)
    before = SSD.launches
    y, st = ssd(*t, chunk=8)
    y_plain, st_plain = ssd_plain(*t, chunk=8)
    assert torch.equal(y, y_plain) and torch.equal(st, st_plain)
    assert SSD.launches == before
    meta = [v.to("meta") for v in t]
    with pytest.raises(ValueError, match="device"):
        ssd(*meta, chunk=8)


@pytest.fixture(scope="module")
def fed_block():
    """Reduced mamba2 layer 0 through the reference's chunk-fed scan (the
    Pallas kernel in interpret mode, ``ssm_stream_segments=3``): one
    reference run shared by the tests below."""
    cfg_ref = dataclasses.replace(ref_get_config("mamba2-2.7b").reduced(),
                                  attn_impl="pallas", ssm_stream_segments=3)
    ref_params = ref_init_params(cfg_ref, jax.random.PRNGKey(0))
    lp_ref = jax.tree.map(lambda v: v[0], ref_params["layers"])
    x = np.random.default_rng(1).standard_normal(
        (2, 4 * cfg_ref.ssm_chunk + 3, cfg_ref.d_model)).astype(np.float32)
    want = ref_layers.mamba2_block(cfg_ref, lp_ref["mamba"], jnp.asarray(x))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params))
    return get_config("mamba2-2.7b").reduced(), params["layers"][0], x, want


def test_chunk_fed_block_matches_reference(fed_block):
    """The port's segment loop (cuts on ``ssm_chunk`` boundaries, ragged
    tail in the last segment) against the reference's chunk-fed block, and
    bit-identical to the port's own one-call block."""
    cfg, lp, x, want = fed_block
    fed_cfg = dataclasses.replace(cfg, ssm_stream_segments=3)
    xt = torch.from_numpy(x)
    fed = layers.mamba2_block(fed_cfg, lp["mamba"], xt)
    _close(fed, want)
    bulk = layers.mamba2_block(cfg, lp["mamba"], xt)
    assert torch.equal(fed, bulk)


def test_chunk_fed_threads_the_state():
    """``ssd_chunk_fed`` over segments cut on chunk boundaries equals one
    call, bit for bit, and hands each segment the previous final state."""
    arrs, st0 = _inputs(35, seed=6, init=True)
    x, dt, a, b, c, d = _torch(arrs)
    init = torch.from_numpy(st0)
    cuts = [(0, 8), (8, 24), (24, 35)]
    seen = []

    def fetch(k):
        lo, hi = cuts[k]
        seen.append(k)
        return x[:, lo:hi], dt[:, lo:hi], b[:, lo:hi], c[:, lo:hi]

    y, st = ssd_chunk_fed(fetch, len(cuts), a, d, chunk=8, init_state=init)
    y1, st1 = ssd_plain(x, dt, a, b, c, d, chunk=8, init_state=init)
    assert seen == [0, 1, 2]
    assert torch.equal(y, y1) and torch.equal(st, st1)
    with pytest.raises(ValueError):
        ssd_chunk_fed(fetch, 0, a, d)
