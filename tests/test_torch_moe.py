"""The port's MoE family against the reference, in fp32 at ``reduced()``:
``llama4-scout-17b-a16e`` (4 experts, top-1, a shared expert, SiLU) and
``grok-1-314b`` (4 experts, top-2, GeGLU, no shared expert).

Held: the routing decisions (``idx``, ``keep``, ``dst``, ``cap``) equal
the reference's exactly at a tight, the published and an overflow-free
capacity, a zero input row (uniform probabilities: a tie that goes to the
lower expert index) included; ``lax.top_k``'s tie order; dispatch
(bit for bit), combine, the expert products and the layer in both
branches (capacity dispatch, and ``dense_combine``); the load-balancing
loss and ``loss_fn``'s ``moe_aux``; ``moe_chunk_agree_mask`` in both
directions; forward logits, bulk prefill, chunked prefill against the
reference's chunks (chunk-local capacity) and, without overflow, against
bulk; decode steps at mixed positions; the parameter count at full
depth, at the cut depth and active-only; the bridge's per-layer dicts;
token identity with the reference ``Server`` (chunked), and paged ≡
contiguous; and the refusals of what of expert parallelism is not
ported (ROADMAP queue 1 items 6 and 7).

The reference's parameters cross to the port through
``repro_torch.bridge``; inputs are numpy arrays from a seed.  fp32
tolerance 1e-5: the products and sums run in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_config as ref_get_config
from repro.launch.mesh import make_host_mesh
from repro.models import decode as ref_decode
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.models import prefill as ref_prefill
from repro.runtime import server as ref_server
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, serving_features
from repro_torch.dist.steps import slot_write
from repro_torch.kernels.flash_attention import FLASH
from repro_torch.models import decode, model, prefill
from repro_torch.models import layers as L
from repro_torch.runtime import server

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("llama4-scout-17b-a16e", "grok-1-314b")
CACHE = ("k", "v", "slot_pos", "pos")
CARRY = ("k", "v", "pos")
_ref_decode_step = jax.jit(ref_decode.decode_step, static_argnums=0)


def _close(ours, ref, msg=""):
    np.testing.assert_allclose(ours.detach().cpu().numpy(), np.asarray(ref),
                               err_msg=msg, **TOL)


def _with_cf(cfg, cf):
    """``cfg`` at capacity factor ``cf`` ("n_experts": no choice drops)."""
    if cf is None:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=float(cfg.n_experts) if cf == "n_experts"
        else cf)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(ref cfg, ref params, port cfg, port params): one reference init an
    arch, shared by the module's parity tests."""
    ref_cfg = ref_get_config(request.param).reduced()
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    return (ref_cfg, ref_params, get_config(request.param).reduced(),
            params_from_reference(jax.tree.map(np.asarray, ref_params)))


def _rows(cfg, seed, s=13):
    """MoE-layer input rows (2, s, D) fp32, row 3 of batch 0 all zeros
    (its router logits are 0: every expert ties)."""
    x = np.random.default_rng(seed).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    x[0, 3] = 0.0
    return x


def _moe_params(arch, layer=0):
    _, ref_params, _, params = arch
    ref_moe = jax.tree.map(lambda a: a[layer], ref_params["layers"]["moe"])
    return ref_moe, params["layers"][layer]["moe"]


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a)).long()


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def test_top_k_ties_go_to_lower_index():
    """``layers.top_k`` against ``lax.top_k`` on rows full of ties."""
    rng = np.random.default_rng(0)
    probs = (rng.integers(0, 3, size=(64, 8)) / 4.0).astype(np.float32)
    probs[0] = 0.125                                  # every entry ties
    for k in (1, 2, 3, 8):
        want_v, want_i = lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = L.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("cf", [0.25, None, "n_experts"])
def test_route_decisions_equal_reference(arch, cf):
    """idx, keep, dst and cap exactly, the weights at 1e-5; the zero row
    routes to the lowest expert indices."""
    ref_cfg, _, cfg, _ = arch
    ref_cfg, cfg = _with_cf(ref_cfg, cf), _with_cf(cfg, cf)
    ref_moe, moe = _moe_params(arch)
    x = _rows(cfg, seed=1)
    want = ref_layers.moe_route(ref_cfg, ref_moe["router"], jnp.asarray(x))
    got = L.moe_route(cfg, moe["router"], torch.from_numpy(x))
    assert got[4] == want[4]
    for name, g, w in zip(("idx", "keep", "dst"), got[1:4], want[1:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
    _close(got[0], want[0], "weights")
    k = cfg.experts_per_token
    assert got[1][0, 3].tolist() == list(range(k))
    if cf == 0.25:
        assert not bool(got[2].all())            # choices were dropped
    if cf == "n_experts":
        assert bool(got[2].all())


@pytest.mark.parametrize("cf", [0.25, None])
def test_dispatch_expert_ffn_and_combine_match_reference(arch, cf):
    """The reference's routing fed to both: dispatch bit for bit, the
    batched expert products and the combine at 1e-5."""
    ref_cfg, _, cfg, _ = arch
    ref_cfg, cfg = _with_cf(ref_cfg, cf), _with_cf(cfg, cf)
    ref_moe, moe = _moe_params(arch)
    x = _rows(cfg, seed=2)
    w, _, keep, dst, cap = ref_layers.moe_route(ref_cfg, ref_moe["router"],
                                                jnp.asarray(x))
    e = cfg.n_experts
    ref_xe = ref_layers.moe_dispatch(jnp.asarray(x), dst, keep, e, cap)
    xe = L.moe_dispatch(torch.from_numpy(x), _t(dst),
                        torch.from_numpy(np.array(keep)), e, cap)
    np.testing.assert_array_equal(xe.numpy(), np.asarray(ref_xe))
    ref_ye = ref_layers._expert_ffn(ref_cfg, ref_moe, ref_xe)
    ye = L._expert_ffn(cfg, moe, xe)
    _close(ye, ref_ye, "expert ffn")
    y = L.moe_combine(ye, _t(dst), torch.from_numpy(np.array(keep)),
                      torch.from_numpy(np.array(w)))
    _close(y, ref_layers.moe_combine(ref_ye, dst, keep, w), "combine")


@pytest.mark.parametrize("dense_combine", [False, True])
@pytest.mark.parametrize("s", [1, 13])
def test_moe_layer_matches_reference(arch, dense_combine, s):
    ref_cfg, _, cfg, _ = arch
    ref_moe, moe = _moe_params(arch, layer=1)
    x = _rows(cfg, seed=3, s=13)[:, :s]
    want = ref_layers.moe(ref_cfg, ref_moe, jnp.asarray(x),
                          dense_combine=dense_combine)
    got = L.moe(cfg, moe, torch.from_numpy(x), dense_combine=dense_combine)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)


def test_aux_loss_and_loss_fn(arch):
    """``moe_aux_loss`` of one layer, and ``loss_fn``'s ``moe_aux`` (the
    layers' sum) and total against the reference's."""
    ref_cfg, ref_params, cfg, params = arch
    ref_moe, moe = _moe_params(arch)
    x = _rows(cfg, seed=4)
    _close(L.moe_aux_loss(cfg, torch.from_numpy(x), moe),
           ref_layers.moe_aux_loss(ref_cfg, jnp.asarray(x), ref_moe))
    toks = _tokens(cfg, 2, 13, seed=5)
    labels = np.where(np.arange(13) % 5 == 4, -1, toks).astype(np.int32)
    ref_total, ref_m = ref_model.loss_fn(
        ref_cfg, ref_params, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)})
    total, m = model.loss_fn(cfg, params, {"tokens": _t(toks),
                                           "labels": _t(labels)})
    assert set(m) == set(ref_m)
    for k in m:
        _close(m[k], ref_m[k], k)
    _close(total, ref_total, "total")
    assert m["moe_aux"].item() > 0


@pytest.mark.parametrize("cf,agrees", [("n_experts", True), (0.25, False)])
def test_chunk_agree_mask_both_directions(arch, cf, agrees):
    """The reference's ``TestMoEChunkBound``: at a capacity factor of
    n_experts the chunk-local and bulk keep decisions agree everywhere; at
    0.25 they differ and the mask names the rows.  The masks are the
    reference's, exactly."""
    ref_cfg, _, cfg, _ = arch
    ref_cfg, cfg = _with_cf(ref_cfg, cf), _with_cf(cfg, cf)
    ref_moe, moe = _moe_params(arch)
    x = _rows(cfg, seed=6, s=16)
    cuts = prefill.prefill_chunk_cuts(16, n_chunks=4)
    want = ref_prefill.moe_chunk_agree_mask(ref_cfg, ref_moe,
                                            jnp.asarray(x), cuts)
    got = prefill.moe_chunk_agree_mask(cfg, moe, torch.from_numpy(x), cuts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[0].all()) == agrees
    # chunked, and declared inexact whatever the capacity
    assert prefill.chunk_support(cfg) == (True, "")
    assert not serving_features(cfg)["chunked_exact"]


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------


def test_forward_logits(arch):
    ref_cfg, ref_params, cfg, params = arch
    toks = _tokens(cfg, 2, 13, seed=7)
    ref_logits, ref_aux = ref_model.forward(ref_cfg, ref_params,
                                            jnp.asarray(toks))
    before = FLASH.launches
    logits, aux = model.forward(cfg, params, _t(toks), return_aux=True)
    _close(logits, ref_logits, "logits")
    _close(aux, ref_aux, "aux")
    assert FLASH.launches == before            # the plain version on CPU


@pytest.mark.parametrize("s", [3, 13])
def test_bulk_prefill_cache_and_logits(arch, s):
    ref_cfg, ref_params, cfg, params = arch
    toks = _tokens(cfg, 2, s, seed=8)
    ref_cache, ref_logits = ref_prefill.prefill(ref_cfg, ref_params,
                                                jnp.asarray(toks),
                                                cache_len=16)
    cache, logits = prefill.prefill(cfg, params, _t(toks), cache_len=16)
    assert set(cache) == set(ref_cache) == set(CACHE)
    _close(logits, ref_logits, "logits")
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)


def test_chunked_prefill_sequence(arch):
    """A ragged cut (5, 5, 3) at the published capacity: each chunk's
    carry and logits match the reference's chunks (capacity bookkept
    over the chunk's rows), and the finished cache the reference's."""
    ref_cfg, ref_params, cfg, params = arch
    s = 13
    toks = _tokens(cfg, 1, s, seed=9)
    cuts = prefill.prefill_chunk_cuts(s, chunk_len=5)
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
    for k in CACHE:
        _close(cache[k], ref_cache[k], k)


def test_chunked_equals_bulk_without_overflow(arch):
    """At ``capacity_factor = n_experts`` no choice drops in either
    program: chunked prefill ≡ bulk (cache and logits)."""
    _, ref_params, cfg, params = arch
    cfg = _with_cf(cfg, "n_experts")
    toks = _tokens(cfg, 1, 13, seed=10)
    bulk, bulk_logits = prefill.prefill(cfg, params, _t(toks), cache_len=16)
    scr = prefill.init_prefill_scratch(cfg, 1, 13, "cpu")
    for lo, hi in prefill.prefill_chunk_cuts(13, chunk_len=4):
        scr, logits = prefill.prefill_chunk(cfg, params, scr,
                                            _t(toks[:, lo:hi]), lo)
    cache = prefill.scratch_to_cache(cfg, scr, cache_len=16)
    _close(logits, bulk_logits.numpy(), "logits")
    for k in CACHE:
        _close(cache[k], bulk[k].numpy(), k)


def test_decode_steps_at_mixed_positions(arch):
    """A batch-2 cache prefilled to 5 and 9 tokens, written row by row
    with ``slot_write``, decoded for 4 steps (every expert on every row)
    against the reference's jitted ``decode_step``."""
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


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("depth", ["published", "cut", "reduced"])
def test_count_params_analytic_matches_reference(name, depth):
    ours, ref = get_config(name), ref_get_config(name)
    if depth == "cut":
        n = 8 if name.startswith("llama4") else 2
        ours = dataclasses.replace(ours, n_layers=n)
        ref = dataclasses.replace(ref, n_layers=n)
    elif depth == "reduced":
        ours, ref = ours.reduced(), ref.reduced()
    for active in (False, True):
        assert model.count_params_analytic(ours, active_only=active) == \
            ref_model.count_params_analytic(ref, active_only=active)
    want = {("llama4-scout-17b-a16e", "cut"): 19_685_790_720,
            ("llama4-scout-17b-a16e", "published"): 107_769_861_120,
            ("grok-1-314b", "cut"): 11_450_578_944,
            ("grok-1-314b", "published"): 316_489_340_928}
    if depth == "reduced":
        assert model.count_params(model.init_params(ours, 0, "cpu")) == \
            model.count_params_analytic(ours)
    else:
        assert model.count_params_analytic(ours) == want[(name, depth)]


def test_bridge_and_init_follow_reference():
    """An 8-layer variant of reduced llama4-scout (the reference's
    parameter tree, drawn with numpy): the bridge gives every layer its
    own dict (router, the three stacked experts, the shared expert) equal
    to the reference's slice, in storage of its own; the port's init
    draws the same leaves at the same shapes and types."""
    from repro_torch.dist import sharding

    name = "llama4-scout-17b-a16e"
    ref_cfg = dataclasses.replace(ref_get_config(name).reduced(), n_layers=8)
    cfg = dataclasses.replace(get_config(name).reduced(), n_layers=8)
    ref_params = _std03_params(ref_cfg, seed=1)
    params = params_from_reference(ref_params)
    assert len(params["layers"]) == 8
    ptrs = set()
    for i, lp in enumerate(params["layers"]):
        moe = lp["moe"]
        assert set(moe) == {"router", "w_up", "w_gate", "w_down", "shared"}
        assert moe["router"].dtype == torch.float32
        assert moe["w_up"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
        assert moe["w_down"].shape == (cfg.n_experts, cfg.d_ff, cfg.d_model)
        for key in ("router", "w_up", "w_gate", "w_down"):
            np.testing.assert_array_equal(
                moe[key].numpy(), ref_params["layers"]["moe"][key][i])
            ptrs.add(moe[key].data_ptr())
        np.testing.assert_array_equal(
            moe["shared"]["w_down"].numpy(),
            ref_params["layers"]["moe"]["shared"]["w_down"][i])
    assert len(ptrs) == 8 * 4
    want = dict(sharding.leaves(params))
    got = dict(sharding.leaves(model.init_params(cfg, seed=0,
                                                 device="cpu")))
    assert set(got) == set(want)
    for path, t in got.items():
        assert t.shape == want[path].shape and t.dtype == want[path].dtype, \
            path


# ---------------------------------------------------------------------------
# the server, and what is not ported
# ---------------------------------------------------------------------------

SRV = dict(max_batch=2, max_seq=32, max_new_tokens=5, prefill_chunk=4)
MODES = {"contiguous": {}, "paged": dict(paged=True, block_size=4)}


def _std03_params(cfg, seed=0):
    """The reference's parameter shapes drawn with numpy: std 0.3
    matrices (the router too), norm scales 1 + N(0, 0.1) (at the 0.02
    init every request repeats one token)."""
    shapes = jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """Three requests of 8 tokens, one arrival every 2 steps, chunks of
    4 (chunk-local capacity on both sides); the reference server's
    tokens."""
    ref_cfg = ref_get_config(request.param).reduced()
    np_params = _std03_params(ref_cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, ref_cfg.vocab_size, size=8)
               for _ in range(3)]
    srv = ref_server.Server(ref_cfg, jax.tree.map(jnp.asarray, np_params),
                            make_host_mesh(1, 1),
                            srv=ref_server.ServerConfig(**SRV))
    ref_server.drive_arrivals(srv, prompts, 2)
    want = {r.rid: list(r.out_tokens) for r in srv.done}
    return (get_config(request.param).reduced(),
            params_from_reference(np_params), prompts, want)


@pytest.mark.parametrize("mode", list(MODES))
def test_tokens_equal_reference_server(served, mode):
    """Contiguous and paged: the reference server's tokens, so paged ≡
    contiguous."""
    cfg, params, prompts, want = served
    srv = server.Server(cfg, params, server.ServerConfig(**SRV,
                                                         **MODES[mode]),
                        device="cpu")
    server.drive_arrivals(srv, prompts, 2)
    got = {r.rid: list(r.out_tokens) for r in srv.done}
    assert got == want
    assert len(got) == 3 and all(len(t) == 5 for t in got.values())
    assert len({tuple(t) for t in got.values()}) > 1
    st = srv.stats()
    assert st["admission_mode"] == "chunked(4)"
    assert st["prefill_chunks"] == 6


@pytest.mark.parametrize("name", ARCHS)
def test_expert_parallel_paths_raise_naming_the_roadmap(name, monkeypatch):
    """Expert parallelism trains and decodes (``tests/test_torch_moe_ep.py``),
    on every MoE transport (a preset's own ``auto`` and ``bidir`` too);
    what of it still raises names its ROADMAP item: int8 compression of
    the data axis inside the step (``ROADMAP_COMPRESS``; the data axis
    itself trains, as ``tests/test_torch_train_mesh.py`` holds) when the
    step is built; ``launch/serve.py --full`` at the published depth
    refuses before it draws a parameter, stating the bytes and naming the
    ``Server`` over an expert group (item 7.6), and passes the depth cut
    on."""
    import re

    from repro_torch.configs import EP_PRESETS
    from repro_torch.dist.group import Group
    from repro_torch.dist.steps import (
        ROADMAP_COMPRESS,
        StepConfig,
        TransportPolicy,
        build_train_step,
    )
    from repro_torch.launch import serve as launch_serve

    cfg = get_config(name).reduced()
    group = Group(rank=0, size=2, device=torch.device("cpu"))
    preset = next(p for p in EP_PRESETS.values() if p.arch == name)
    assert callable(build_train_step(cfg, group, StepConfig(
        transport=TransportPolicy(moe="ring"))))
    for scfg in (preset.step,
                 StepConfig(transport=TransportPolicy(moe="bidir"))):
        assert callable(build_train_step(cfg, group, scfg))
    with pytest.raises(NotImplementedError,
                       match=re.escape(ROADMAP_COMPRESS)):
        build_train_step(cfg, group, StepConfig(transport=TransportPolicy(
            moe="ring", compress_cross_pod=True)))

    def no_init(*a, **k):
        raise AssertionError("a parameter was drawn")

    monkeypatch.setattr(model, "init_params", no_init)
    with pytest.raises(SystemExit, match=(r"48 layers needs 215\.5 GB"
                       if name.startswith("llama4") else
                       r"64 layers needs 633\.0 GB") + r".*item 7\.6"):
        launch_serve.main(["--device", "cpu", "--arch", name, "--full"])
    cut = "8" if name.startswith("llama4") else "2"
    with pytest.raises(AssertionError, match="a parameter was drawn"):
        launch_serve.main(["--device", "cpu", "--arch", name, "--full",
                           "--layers", cut])      # the depth cut fits
