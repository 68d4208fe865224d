"""The SSD scan's gradient in the port against the reference's.

The reference trains through ``repro.models.layers.ssd_jnp``, and its
gradient is XLA's autodiff of that scan; the port's is
``kernels.ssd.ref.ssd_bwd_plain`` (the backward kernels' oracle) on the
CPU and ``csrc/ssd_bwd.cu`` on the card.  Here, in fp32 from seeded numpy
inputs:

* ``ssd_bwd_plain`` against ``jax.vjp`` of ``ssd_jnp`` and against
  ``torch.autograd`` of ``ssd_plain``, with and without ``init_state`` and
  a ``dstate`` cotangent, ragged S, one and two groups, chunks 8 and 32;
* the ``ssd`` wrapper's gradients (its ``torch.autograd.Function``) on the
  CPU against both, and ``ssd_chunk_fed``'s against the bulk call's;
* the Mamba-2 block's gradients with remat full against remat none;
* the bf16 backward kernels' precision plan, ``ssd_bwd_bf16_emulated``
  (bf16 operands, fp32 operands as bf16 high and low parts, dB and dC
  summed over head tiles), on bf16-rounded inputs: against ``jax.vjp`` of
  ``ssd_jnp`` at the chip smoke's bf16 tolerance (1e-2 of each gradient's
  largest magnitude), and against ``ssd_bwd_plain`` given the same kept
  entering states (bf16 for chunks 1.., ``init_state`` in fp32) tightly:
  dx, dB and dC to 2^-8 (their bf16 rounding), ddt, da, dd and d
  init_state to 2e-5 (the splits leave ~2^-17 of each product; measured
  ≤ 5e-6 at these sizes).

Tolerance: every gradient within 1e-5 of its largest magnitude (max
|error| ≤ 1e-5 · max |want|): the same fp32 arithmetic summed in another
order (the split's measured gap to the reference is ≤ ~4e-6 at these
sizes), except ``da`` at 1e-4: it sums dt × (the reverse cumsum of dcum)
over every row, terms of both signs far larger than the sum, and at
(B 1, S 40, H 2, N 8, P 4, chunk 8) the reference's own fp32 ``da`` is
3.7e-5 of its largest magnitude from an fp64 evaluation of the same
gradient (the plain split 1.3e-5).  Remat full against none: 1e-6, the
same operations recomputed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import ssd_jnp
from repro_torch.configs import get_config
from repro_torch.dist import sharding
from repro_torch.kernels.ssd import (
    ssd,
    ssd_bwd,
    ssd_bwd_bf16_emulated,
    ssd_bwd_plain,
    ssd_chunk_fed,
    ssd_plain,
)
from repro_torch.models import model

NAMES = ("dx", "ddt", "da", "db", "dc", "dd", "dinit")
#: max |error| over max |want|, by gradient (see the module docstring)
REL = dict.fromkeys(NAMES, 1e-5) | {"da": 1e-4}


def _inputs(bsz, s, h, g, n, p, seed):
    """x, dt, a, b, c, d, init_state, dy, dstate as numpy fp32, drawn as the
    model makes them (softplus dt, a = −exp(a_log))."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((bsz, s, h, p)).astype(f32),
        dt=np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(f32),
        a=-np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(f32),
        b=rng.standard_normal((bsz, s, g, n)).astype(f32),
        c=rng.standard_normal((bsz, s, g, n)).astype(f32),
        d=rng.standard_normal((h,)).astype(f32),
        init=rng.standard_normal((bsz, h, n, p)).astype(f32),
        dy=rng.standard_normal((bsz, s, h, p)).astype(f32),
        dstate=rng.standard_normal((bsz, h, n, p)).astype(f32))


def _t(arrs, *keys):
    return [torch.from_numpy(arrs[k].copy()) for k in keys]


def _reference(arrs, chunk, init, dstate):
    """Gradients of ``ssd_jnp`` by ``jax.vjp``: (dx, ddt, da, db, dc, dd,
    d init_state) as numpy."""
    def fn(x, dt, a, b, c, d, st):
        return ssd_jnp(x, dt, a, b, c, d, chunk,
                       init_state=st if init else None)

    prim = [jnp.asarray(arrs[k]) for k in ("x", "dt", "a", "b", "c", "d",
                                           "init")]
    _, vjp = jax.vjp(fn, *prim)
    ds = arrs["dstate"] if dstate else np.zeros_like(arrs["dstate"])
    return [np.asarray(v) for v in vjp((jnp.asarray(arrs["dy"]),
                                        jnp.asarray(ds)))]


def _autograd(fn, arrs, init, dstate):
    """Gradients of ``fn(x, dt, a, b, c, d, init_state) -> (y, state)`` by
    torch.autograd for the cotangents dy and dstate."""
    ins = [t.requires_grad_(True) for t in _t(arrs, "x", "dt", "a", "b",
                                              "c", "d", "init")]
    y, st = fn(*ins[:6], ins[6] if init else None)
    outs, cots = [y], [torch.from_numpy(arrs["dy"])]
    if dstate:
        outs.append(st)
        cots.append(torch.from_numpy(arrs["dstate"]))
    torch.autograd.backward(outs, cots)
    return [None if t.grad is None else t.grad.numpy() for t in ins]


def _close(got, want):
    for name, g, w in zip(NAMES, got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        err = np.abs(g - w).max()
        assert err <= REL[name] * np.abs(w).max(), (name, err,
                                                    np.abs(w).max())


CASES = [  # (B, S, H, G, N, P, chunk, init_state, dstate)
    (2, 64, 4, 1, 8, 16, 8, False, False),    # chunks of 8, from zeros
    (2, 77, 4, 2, 8, 16, 8, True, True),      # ragged, two groups, a state
    (1, 96, 6, 2, 16, 8, 32, True, False),    # chunk 32, init_state only
    (2, 50, 4, 1, 16, 16, 32, False, True),   # ragged chunk 32, dstate only
    (1, 40, 2, 1, 8, 4, 8, True, True),       # one head a group
    (2, 20, 4, 2, 8, 8, 32, True, True),      # one ragged chunk
]


@pytest.mark.parametrize("bsz,s,h,g,n,p,chunk,init,dstate", CASES)
def test_bwd_plain_matches_jax_vjp(bsz, s, h, g, n, p, chunk, init, dstate):
    arrs = _inputs(bsz, s, h, g, n, p, seed=s + n + chunk)
    want = _reference(arrs, chunk, init, dstate)
    x, dt, a, b, c, d, st, dy, ds = _t(arrs, "x", "dt", "a", "b", "c", "d",
                                       "init", "dy", "dstate")
    got = ssd_bwd_plain(x, dt, a, b, c, d, dy, ds if dstate else None,
                        chunk=chunk, init_state=st if init else None)
    assert [t.dtype for t in got] == [torch.float32] * 7
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    _close(got if init else got[:6], want if init else want[:6])


@pytest.mark.parametrize("bsz,s,h,g,n,p,chunk,init,dstate", CASES[1:4])
def test_bwd_plain_matches_autograd_of_plain(bsz, s, h, g, n, p, chunk,
                                             init, dstate):
    arrs = _inputs(bsz, s, h, g, n, p, seed=7 * s)
    want = _autograd(lambda *t: ssd_plain(*t[:6], chunk=chunk,
                                          init_state=t[6]),
                     arrs, init, dstate)
    x, dt, a, b, c, d, st, dy, ds = _t(arrs, "x", "dt", "a", "b", "c", "d",
                                       "init", "dy", "dstate")
    got = ssd_bwd_plain(x, dt, a, b, c, d, dy, ds if dstate else None,
                        chunk=chunk, init_state=st if init else None)
    _close(got if init else got[:6], want if init else want[:6])


def test_bwd_plain_takes_the_forwards_entering_states():
    """Given the states entering each chunk (what the kernel keeps), the
    plain backward gives the gradients it gives when it recomputes them."""
    arrs = _inputs(2, 70, 4, 2, 8, 16, seed=3)
    x, dt, a, b, c, d, st, dy, ds = _t(arrs, "x", "dt", "a", "b", "c", "d",
                                       "init", "dy", "dstate")
    chunk, nc = 16, 5
    # the entering states, chunk by chunk through the forward's own carry
    s_in, state = [], st
    for k in range(nc):
        s_in.append(state)
        lo, hi = k * chunk, min((k + 1) * chunk, 70)
        _, state = ssd_plain(x[:, lo:hi], dt[:, lo:hi], a, b[:, lo:hi],
                             c[:, lo:hi], d, chunk=chunk, init_state=state)
    kept = ssd_bwd_plain(x, dt, a, b, c, d, dy, ds, chunk=chunk,
                         init_state=st, s_in=torch.stack(s_in, dim=1))
    again = ssd_bwd_plain(x, dt, a, b, c, d, dy, ds, chunk=chunk,
                          init_state=st)
    _close(kept, [t.numpy() for t in again])


@pytest.mark.parametrize("bsz,s,h,g,n,p,chunk,init,dstate",
                         [CASES[1], CASES[3]])
def test_function_cpu_grads_match_jax_and_autograd(bsz, s, h, g, n, p,
                                                   chunk, init, dstate):
    """``ssd`` records its own ``grad_fn`` on the CPU: its gradients are
    ``ssd_bwd``'s, held to the reference's and to autograd of the plain
    scan."""
    arrs = _inputs(bsz, s, h, g, n, p, seed=11 + s)

    def through_wrapper(*t):
        y, state = ssd(*t[:6], chunk=chunk, init_state=t[6])
        assert type(y.grad_fn).__name__ == "_ScanBackward"
        return y, state

    got = _autograd(through_wrapper, arrs, init, dstate)
    for want in (_reference(arrs, chunk, init, dstate),
                 _autograd(lambda *t: ssd_plain(*t[:6], chunk=chunk,
                                                init_state=t[6]),
                           arrs, init, dstate)):
        _close(got if init else got[:6], want if init else want[:6])
    x, dt, a, b, c, d, st, dy, ds = _t(arrs, "x", "dt", "a", "b", "c", "d",
                                       "init", "dy", "dstate")
    direct = ssd_bwd(x, dt, a, b, c, d, dy, ds if dstate else None,
                     chunk=chunk, init_state=st if init else None)
    _close(direct if init else direct[:6], got if init else got[:6])


def test_no_grad_and_no_requires_grad_skip_the_function():
    """Serving calls (no_grad, or inputs that need no gradient) run the
    forward alone: outputs with no ``grad_fn``, the plain version's
    values."""
    arrs = _inputs(1, 40, 4, 1, 8, 16, seed=5)
    ins = _t(arrs, "x", "dt", "a", "b", "c", "d")
    want = ssd_plain(*ins, chunk=16)
    for ctx, leaf in ((torch.no_grad(), True), (torch.enable_grad(), False)):
        with ctx:
            y, st = ssd(*[t.clone().requires_grad_(leaf) for t in ins],
                        chunk=16)
        assert y.grad_fn is None and st.grad_fn is None
        assert torch.equal(y, want[0]) and torch.equal(st, want[1])


@pytest.mark.parametrize("cuts", [[(0, 32), (32, 64), (64, 77)],
                                  [(0, 8), (8, 77)]])
def test_chunk_fed_grads_match_bulk(cuts):
    """The chunk-fed scan carries each segment's final-state gradient into
    the previous segment's reverse pass (through ``init_state``): its
    gradients equal the bulk call's."""
    arrs = _inputs(2, 77, 4, 2, 8, 16, seed=9)
    chunk = 8

    def fed(x, dt, a, b, c, d, st):
        def fetch(k):
            lo, hi = cuts[k]
            return x[:, lo:hi], dt[:, lo:hi], b[:, lo:hi], c[:, lo:hi]

        return ssd_chunk_fed(fetch, len(cuts), a, d, chunk=chunk,
                             init_state=st)

    got = _autograd(fed, arrs, True, True)
    want = _autograd(lambda *t: ssd(*t[:6], chunk=chunk, init_state=t[6]),
                     arrs, True, True)
    _close(got, want)


@pytest.mark.parametrize("segments", [0, 3])
def test_mamba2_remat_full_matches_none(segments):
    """Reduced mamba2's loss gradients with every block recomputed in
    backward (remat full: the scan's forward runs again) equal those with
    nothing recomputed, for the bulk and the chunk-fed scan."""
    base = dataclasses.replace(get_config("mamba2-2.7b").reduced(),
                               ssm_stream_segments=segments)
    params = model.init_params(base, seed=1, device="cpu")
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, base.vocab_size,
                                                     size=(2, 40))),
             "labels": torch.from_numpy(rng.integers(0, base.vocab_size,
                                                     size=(2, 40)))}
    grads = []
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        tree = sharding.map_leaves(
            lambda _, t: t.clone().requires_grad_(True), params)
        loss, _ = model.loss_fn(cfg, tree, batch)
        loss.backward()
        grads.append([t.grad for _, t in sharding.leaves(tree)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(
            b.abs().max()))


#: the bf16 emulation against the reference: the chip smoke's bf16
#: tolerance; against the plain backward on the same kept states: the
#: bf16 outputs to their rounding (2^-8), the fp32 ones to 2e-5
BF16_REF_REL = 1e-2
BF16_PLAIN_REL = dict.fromkeys(("dx", "db", "dc"), 2.0 ** -8) | dict.fromkeys(
    ("ddt", "da", "dd", "dinit"), 2e-5)
BF16_CASES = [  # (B, S, H, G, N, P, chunk, head tile, init_state, dstate)
    (2, 300, 4, 1, 32, 16, 64, 3, True, True),    # ragged; tiles of 3 and 1
    (1, 200, 6, 2, 16, 32, 32, 2, False, True),   # two groups; tiles 2 + 1
    (2, 130, 3, 1, 24, 8, 128, 2, True, False),   # a chunk and a 2-row one
    (1, 256, 4, 1, 32, 32, 64, 4, True, True),    # one tile of a group
]


def _bf16_inputs(bsz, s, h, g, n, p, seed):
    """``_inputs`` with x, b, c and dy rounded to bf16 (as the kernels take
    them; the reference sees the same values in fp32)."""
    arrs = _inputs(bsz, s, h, g, n, p, seed)
    for k in ("x", "b", "c", "dy"):
        arrs[k] = torch.from_numpy(arrs[k]).bfloat16().float().numpy()
    return arrs


def _kept_states(x, dt, a, b, c, chunk, init):
    """The states entering each chunk as the forward keeps them: bf16 for
    chunks 1.. (its pass rounds them), and chunk 0's ``init`` in fp32
    (the backward reads ``init_state`` itself)."""
    bsz, s, h, p = x.shape
    cuts = range(0, s, chunk)
    state = torch.zeros(bsz, h, b.shape[3], p) if init is None else init
    kept = []
    for lo in cuts:
        kept.append(state if lo == 0 else state.bfloat16().float())
        hi = min(lo + chunk, s)
        _, state = ssd_plain(x[:, lo:hi], dt[:, lo:hi], a, b[:, lo:hi],
                             c[:, lo:hi], torch.zeros(h), chunk=chunk,
                             init_state=state)
    return torch.stack(kept, dim=1)


@pytest.mark.parametrize("bsz,s,h,g,n,p,chunk,ht,init,dstate", BF16_CASES)
def test_bf16_emulation_matches_jax_vjp(bsz, s, h, g, n, p, chunk, ht, init,
                                        dstate):
    arrs = _bf16_inputs(bsz, s, h, g, n, p, seed=s + h + ht)
    want = _reference(arrs, chunk, init, dstate)
    x, dt, a, b, c, d, st, dy, ds = _t(arrs, "x", "dt", "a", "b", "c", "d",
                                       "init", "dy", "dstate")
    got = ssd_bwd_bf16_emulated(
        x.bfloat16(), dt, a, b.bfloat16(), c.bfloat16(), d, dy.bfloat16(),
        ds if dstate else None, chunk=chunk, init_state=st if init else None,
        ht=ht)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32,
                                      torch.float32]
    for name, u, w in zip(NAMES, got, want):
        if name == "dinit" and not init:
            continue
        err = np.abs(u.float().numpy() - w).max()
        assert err <= BF16_REF_REL * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("bsz,s,h,g,n,p,chunk,ht,init,dstate", BF16_CASES)
def test_bf16_emulation_matches_plain_on_kept_states(bsz, s, h, g, n, p,
                                                     chunk, ht, init,
                                                     dstate):
    """Given the same kept entering states, the bf16 plan moves ddt and da
    (sums of both signs through the reverse cumsum) by no more than its
    splits: the states' own bf16 rounding is the forward's, not the
    backward's."""
    arrs = _bf16_inputs(bsz, s, h, g, n, p, seed=3 * s + ht)
    x, dt, a, b, c, d, st, dy, ds = _t(arrs, "x", "dt", "a", "b", "c", "d",
                                       "init", "dy", "dstate")
    st, ds = (st if init else None), (ds if dstate else None)
    kept = _kept_states(x, dt, a, b, c, chunk, st)
    got = ssd_bwd_bf16_emulated(
        x.bfloat16(), dt, a, b.bfloat16(), c.bfloat16(), d, dy.bfloat16(),
        ds, chunk=chunk, init_state=st, s_in=kept.bfloat16(), ht=ht)
    want = ssd_bwd_plain(x, dt, a, b, c, d, dy, ds, chunk=chunk,
                         init_state=st, s_in=kept)
    for name, u, w in zip(NAMES, got, want):
        err = (u.float() - w).abs().max().item()
        assert err <= BF16_PLAIN_REL[name] * w.abs().max().item(), (name, err)


def test_bwd_plan_and_scratch():
    """The bf16 backward's head tiles fill whole waves of 132 SMs (one
    block an SM): 40 heads a block at the training microbatch (128 blocks),
    10 at one batch row; fp32 takes one head a block.  Its dB and dC
    scratch holds one slot per head tile, so it shrinks by the tile."""
    from repro_torch.kernels.ssd import ops

    args = (2048, 80, 1, 128, 64, 128)
    assert ops.ssd_bwd_plan(4, *args, torch.bfloat16, 132, 1) == 40
    assert ops.ssd_bwd_plan(1, *args, torch.bfloat16, 132, 1) == 10
    assert ops.ssd_bwd_plan(4, *args, torch.float32, 132, 1) == 1
    bf = ops.bwd_scratch(4, *args, torch.bfloat16, 40)
    f32 = ops.bwd_scratch(4, *args, torch.float32, 1)
    assert bf["dbh"][0] == (4, 2048, 2, 128) and f32["dbh"][0] == (
        4, 2048, 80, 128)
    assert bf["ghl"] == ((4, 16, 80, 2, 128, 64), torch.bfloat16)
    assert "ghl" not in f32
    allocated, moved = ops.bwd_scratch_bytes(4, *args, torch.bfloat16, 40)
    assert moved == 2 * allocated < 10 ** 9
