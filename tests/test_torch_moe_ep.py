"""The port's expert parallelism (``models/moe_ep.py``) against the
reference's, on gloo groups of CPU ranks, in fp32 at ``reduced()``.

* the layer: ``moe_ep_ffn`` through ``build_moe_ep_runner`` against the
  reference's runner on an ``("expert", n)`` mesh of its 4 CPU devices
  and against the port's ``layers.moe``, grok-1 at n = 2 and 4 on
  ``xla`` and ``ring``, 6 experts at n = 3 on ``ring``, and llama4-scout
  (a shared expert), at 1e-6 (the reference's ``TestLayerEquivalence``
  tolerance);
* the gradients of the router, the expert shards, the shared expert and
  x against ``jax.grad`` of the reference's runner at 1e-5;
* the streamed exchange bit for bit the bulk one (chunks 2 and 3, and a
  count past the rows that clamps), its gradients too, and a counting
  probe transport: 2 registry calls a layer in bulk, 2 a chunk streamed,
  the same elements in all;
* the all-to-all's backward: the same transport's all-to-all of the
  cotangent, ``ring`` and ``xla``;
* the placement against the reference's ``param_pspecs`` on an expert
  mesh;
* the EP train step against the reference's ``build_train_step`` on
  ``("expert", n)`` with ``moe="ring"`` and 2 microbatches: loss 1e-5,
  grad_norm 1e-4, moe_aux 1e-5 (the reference's own EP tolerances), the
  parameters after one step by ``tests/test_torch_train.py``'s rule, the
  replicated leaves bitwise equal on every rank;
* EP decode through ``serve_step`` against the reference's EP decode
  runner and the port's dense-combine decode at 1e-5;
* the EP presets field for field; the refusals (a batch the group does
  not divide, ``moe="auto"``, ``moe="bidir"``, a data axis).

One gloo world of 2, 3 and 4 ranks a module.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import EP_PRESETS as REF_EP_PRESETS
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.data.pipeline import batch_specs
from repro.dist.sharding import param_pspecs as ref_param_pspecs
from repro.dist.steps import StepConfig as RefStepConfig
from repro.dist.steps import TransportPolicy as RefTransportPolicy
from repro.dist.steps import build_init as ref_build_init
from repro.dist.steps import build_train_step as ref_build_train_step
from repro.models import decode as ref_decode
from repro.models import model as ref_model
from repro.models import moe_ep as ref_moe_ep
from repro.models import prefill as ref_prefill
from repro_torch.bridge import params_from_reference, shard_params
from repro_torch.configs import (
    EP_PRESET_NAMES,
    EP_PRESETS,
    get_config,
    get_ep_preset,
)
from repro_torch.core.conduit import ROADMAP_AUTO, ROADMAP_SUBSTRATE
from repro_torch.dist import rank_tasks, sharding
from repro_torch.dist.group import Group, RankPool, as_grid
from repro_torch.dist.steps import (
    StepConfig,
    TransportPolicy,
    build_init,
    build_train_step,
    split_rows,
)
from repro_torch.models import decode, prefill
from repro_torch.models import layers as L

GROK, LLAMA4 = "grok-1-314b", "llama4-scout-17b-a16e"
LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_KW = dict(seq_chunk=8, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module")
def pools():
    worlds = {n: RankPool(n, device="cpu") for n in (2, 3, 4)}
    yield worlds
    for pool in worlds.values():
        pool.close()


def _mesh(n):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("expert",))


def _cfg(arch, **kw):
    """(reference config, port config) at ``reduced()`` with ``kw``."""
    return (dataclasses.replace(ref_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _layer(ref_cfg, seed=0):
    """One MoE layer's parameters from the reference's init, as numpy."""
    params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return _np(jax.tree.map(lambda a: a[0], params["layers"]["moe"]))


def _inputs(d, batch, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 8, d)).astype(np.float32)
    return x, rng.standard_normal((batch, 8, d)).astype(np.float32)


def _ref_runner(ref_cfg, n, transport, **kw):
    runner = ref_moe_ep.build_moe_ep_runner(ref_cfg, _mesh(n),
                                            transport=transport, **kw)
    assert runner is not None
    return runner


def _port_y(pool, cfg, p_np, x, transport, **kw):
    res = pool.run(rank_tasks.moe_ep_layer, cfg, p_np, x,
                   transport=transport, **kw)
    return np.concatenate([r["y"] for r in res]), res


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("transport", ["xla", "ring"])
def test_layer_matches_reference_and_dense(pools, n, transport):
    """grok-1 (4 experts, top-2): the port's EP layer over n ranks against
    the reference's EP runner on ``("expert", n)`` and the port's dense
    ``layers.moe`` on the whole batch."""
    ref_cfg, cfg = _cfg(GROK)
    p_np = _layer(ref_cfg)
    x, _ = _inputs(cfg.d_model, 4, 1)
    want = jax.jit(lambda p, v: _ref_runner(ref_cfg, n, transport)(
        ref_cfg, p, v))(p_np, x)
    got, _ = _port_y(pools[n], cfg, p_np, x, transport)
    np.testing.assert_allclose(got, np.asarray(want), **LAYER_TOL)
    dense = L.moe(cfg, params_from_reference(p_np), torch.from_numpy(x))
    np.testing.assert_allclose(got, dense.numpy(), **LAYER_TOL)


def test_layer_odd_expert_axis(pools):
    """6 experts over 3 ranks (the ring's odd case), a row a rank."""
    ref_cfg, cfg = _cfg(GROK, n_experts=6)
    p_np = _layer(ref_cfg)
    x, _ = _inputs(cfg.d_model, 3, 2)
    want = jax.jit(lambda p, v: _ref_runner(ref_cfg, 3, "ring")(
        ref_cfg, p, v))(p_np, x)
    got, _ = _port_y(pools[3], cfg, p_np, x, "ring")
    np.testing.assert_allclose(got, np.asarray(want), **LAYER_TOL)


def test_layer_shared_expert(pools):
    """llama4-scout (top-1, a shared expert added outside the exchange)."""
    ref_cfg, cfg = _cfg(LLAMA4)
    assert cfg.n_shared_experts
    p_np = _layer(ref_cfg)
    x, _ = _inputs(cfg.d_model, 4, 3)
    want = jax.jit(lambda p, v: _ref_runner(ref_cfg, 2, "ring")(
        ref_cfg, p, v))(p_np, x)
    got, _ = _port_y(pools[2], cfg, p_np, x, "ring")
    np.testing.assert_allclose(got, np.asarray(want), **LAYER_TOL)


def _ref_grads(ref_cfg, n, p_np, x, ct):
    runner = _ref_runner(ref_cfg, n, "ring")
    return jax.jit(jax.grad(
        lambda p, v: (runner(ref_cfg, p, v) * ct).sum(),
        argnums=(0, 1)))(p_np, x)


def _check_grads(res, ref_p, ref_x, n, e):
    """The ranks' gradients against the reference's: an expert shard's
    whole, a replicated leaf's summed over the ranks, x's by rows."""
    e_loc = e // n
    flat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(ref_p)[0]}
    assert set(flat) == set(res[0]["grads"])
    for name, want in flat.items():
        if sharding.placement(("moe",) + tuple(name.split("/")),
                              "expert") == "expert":
            got = np.concatenate([r["grads"][name] for r in res])
            assert got.shape[0] == n * e_loc
        else:
            got = sum(r["grads"][name] for r in res)
        np.testing.assert_allclose(got, want, err_msg=name, **GRAD_TOL)
    np.testing.assert_allclose(np.concatenate([r["x_grad"] for r in res]),
                               np.asarray(ref_x), **GRAD_TOL)


@pytest.mark.parametrize("arch,n,transport", [(GROK, 2, "ring"),
                                              (GROK, 4, "xla"),
                                              (LLAMA4, 2, "xla")])
def test_grads_match_reference(pools, arch, n, transport):
    """Router, expert shards, the shared expert and x against ``jax.grad``
    of the reference's EP runner, with a fixed cotangent."""
    ref_cfg, cfg = _cfg(arch)
    p_np = _layer(ref_cfg)
    x, ct = _inputs(cfg.d_model, 4, 4)
    ref_p, ref_x = _ref_grads(ref_cfg, n, p_np, x, ct)
    res = pools[n].run(rank_tasks.moe_ep_layer, cfg, p_np, x,
                       transport=transport, cotangent=ct)
    _check_grads(res, ref_p, ref_x, n, cfg.n_experts)


# ---------------------------------------------------------------------------
# the streamed exchange
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["xla", "ring"])
@pytest.mark.parametrize("chunks", [2, 3, 1000])
def test_streamed_equals_bulk_bitwise(pools, transport, chunks):
    """8 rows over 2 ranks: 4 a rank cut in 2 and in 3 chunks (1/2/1 rows),
    and 1000 chunks clamped to the 4 rows."""
    _, cfg = _cfg(GROK)
    p_np = _layer(ref_get_config(GROK).reduced())
    x, _ = _inputs(cfg.d_model, 8, 8)
    bulk, _ = _port_y(pools[2], cfg, p_np, x, transport)
    got, _ = _port_y(pools[2], cfg, p_np, x, transport, stream_chunks=chunks)
    np.testing.assert_array_equal(got, bulk)


def test_streamed_odd_axis_bitwise(pools):
    ref_cfg, cfg = _cfg(GROK, n_experts=6)
    p_np = _layer(ref_cfg)
    x, _ = _inputs(cfg.d_model, 9, 9)
    bulk, _ = _port_y(pools[3], cfg, p_np, x, "ring")
    got, _ = _port_y(pools[3], cfg, p_np, x, "ring", stream_chunks=2)
    np.testing.assert_array_equal(got, bulk)


def test_streamed_grads_equal_bulk(pools):
    _, cfg = _cfg(GROK)
    p_np = _layer(ref_get_config(GROK).reduced())
    x, ct = _inputs(cfg.d_model, 4, 10)
    runs = [pools[2].run(rank_tasks.moe_ep_layer, cfg, p_np, x,
                         transport="ring", cotangent=ct, stream_chunks=c)
            for c in (None, 2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a["x_grad"], b["x_grad"])
        for name in a["grads"]:
            np.testing.assert_allclose(a["grads"][name], b["grads"][name],
                                       rtol=1e-6, atol=1e-7, err_msg=name)


def test_dispatch_goes_through_the_registry(pools):
    """A counting probe transport registered in front of ``ring``: the
    bulk layer calls it twice (there and back), the streamed one twice a
    chunk, with the same elements in all; the values stay the dense
    layer's."""
    _, cfg = _cfg(GROK)
    p_np = _layer(ref_get_config(GROK).reduced())
    x, _ = _inputs(cfg.d_model, 4, 6)
    dense = L.moe(cfg, params_from_reference(p_np), torch.from_numpy(x))
    totals = {}
    for chunks in (None, 2):
        got, res = _port_y(pools[2], cfg, p_np, x, "ring", probe=True,
                           stream_chunks=chunks)
        np.testing.assert_allclose(got, dense.numpy(), **LAYER_TOL)
        totals[chunks] = [(len(r["calls"]), sum(r["calls"])) for r in res]
    assert all(c == 2 for c, _ in totals[None])
    assert all(c == 4 for c, _ in totals[2])
    assert [e for _, e in totals[2]] == [e for _, e in totals[None]]
    with pytest.raises(ValueError):
        TransportPolicy(moe="probe")              # unregistered again


@pytest.mark.parametrize("transport", ["ring", "xla"])
@pytest.mark.parametrize("n", [3, 4])
def test_all_to_all_backward_is_all_to_all_of_cotangent(pools, transport,
                                                        n):
    rng = np.random.default_rng(n)
    xs = rng.standard_normal((n, 2 * n, 3)).astype(np.float32)
    gs = rng.standard_normal((n, 2 * n, 3)).astype(np.float32)
    res = pools[n].run(rank_tasks.all_to_all_grad, transport, xs, gs,
                       chunk_bytes=8)
    blocks = xs.reshape(n, n, 2, 3)           # (src, dst, rows, cols)
    for r, (y, x_grad, a2a_g) in enumerate(res):
        np.testing.assert_array_equal(y, blocks[:, r].reshape(2 * n, 3))
        np.testing.assert_array_equal(x_grad, a2a_g)
        np.testing.assert_array_equal(
            x_grad, gs.reshape(n, n, 2, 3)[:, r].reshape(2 * n, 3))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [LLAMA4, GROK])
def test_placement_matches_reference_param_pspecs(arch):
    """Every leaf's placement on the expert axis against the reference's
    spec on an ``("expert", 2)`` mesh (the stacked layer axis first), and
    ``bridge.shard_params`` cutting the routed experts' E dim."""
    ref_cfg, _ = _cfg(arch)
    params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    specs = ref_param_pspecs(ref_cfg, _mesh(2), params)
    flat = {tuple(str(getattr(k, "key", k)) for k in path): spec
            for path, spec in jax.tree_util.tree_flatten_with_path(specs)[0]}
    full = _np(params)
    seen = set()
    for path, t in sharding.leaves(params_from_reference(full)):
        key = tuple(str(k) for k in path if not isinstance(k, int))
        spec = tuple(flat[key])
        place = sharding.placement(path, "expert")
        want = ("expert" if "expert" in spec else "rep")
        assert place == want, (path, spec)
        if place == "expert":
            assert spec[1] == "expert" and t.shape[0] == ref_cfg.n_experts
            seen.add(path[-1])
    assert seen == ({"w_up", "w_gate", "w_down"})
    for rank in range(2):
        shard = shard_params(full, rank, 2, axis="expert")
        moe = shard["layers"][1]["moe"]
        e = ref_cfg.n_experts // 2
        np.testing.assert_array_equal(
            moe["w_down"].numpy(),
            full["layers"]["moe"]["w_down"][1][rank * e:(rank + 1) * e])
        np.testing.assert_array_equal(moe["router"].numpy(),
                                      full["layers"]["moe"]["router"][1])
        if ref_cfg.n_shared_experts:
            np.testing.assert_array_equal(
                moe["shared"]["w_up"].numpy(),
                full["layers"]["moe"]["shared"]["w_up"][1])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

_REF = {}


def _reference_step(arch, n):
    """The reference's EP step on ``("expert", n)`` with ``moe="ring"``
    and 2 microbatches: initial params, the batch, metrics and the params
    after one step, as numpy."""
    if (arch, n) in _REF:
        return _REF[arch, n]
    cfg = ref_get_config(arch).reduced()
    mesh = _mesh(n)
    scfg = RefStepConfig(microbatches=2, transport=RefTransportPolicy(
        moe="ring"), **STEP_KW)
    data = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=17, global_batch=8))
    batch = data.global_batch(0)
    bundle = ref_build_train_step(cfg, mesh, scfg,
                                  batch_specs(16, 8, cfg.vocab_size))
    params, opt = ref_build_init(cfg, mesh, scfg)[0](jax.random.PRNGKey(0))
    params0 = _np(params)
    params, _, m = bundle.fn(params, opt, batch, jnp.int32(0))
    _REF[arch, n] = dict(
        params0=params0, batches=[{k: np.asarray(v)
                                   for k, v in batch.items()}],
        metrics={k: float(m[k]) for k in ("loss", "grad_norm", "moe_aux")},
        params=_np(params))
    return _REF[arch, n]


_PORT = {}


def _port_step(pools, arch, n, transport):
    key = (arch, n, transport)
    if key not in _PORT:
        ref = _reference_step(arch, n)
        _PORT[key] = pools[n].run(
            rank_tasks.train, arch, steps=1, reduced=True,
            moe_transport=transport,
            step_overrides=dict(STEP_KW, microbatches=2),
            params_np=ref["params0"], batches=ref["batches"],
            return_params=True)
    return _PORT[key]


STEP_CASES = [(GROK, 2, "ring"), (GROK, 2, "xla"), (LLAMA4, 2, "ring")]


@pytest.mark.parametrize("arch,n,transport", STEP_CASES)
def test_ep_step_metrics_match_reference(pools, arch, n, transport):
    ref = _reference_step(arch, n)["metrics"]
    for rank_res in _port_step(pools, arch, n, transport):
        m = rank_res["metrics"][0]
        np.testing.assert_allclose(m["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], ref["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(m["moe_aux"], ref["moe_aux"], rtol=1e-5)
        assert m["tokens"] == 8 * 16


@pytest.mark.parametrize("arch,n,transport", STEP_CASES)
def test_ep_step_params_pass_parameter_rule(pools, arch, n, transport):
    """Every leaf after one step: mean |Δ| within 1e-5 of the leaf's mean
    magnitude, max |Δ| within 2·peak_lr + 1e-5 of its largest (AdamW's
    first update is ±lr wherever the gradient is not zero)."""
    ref = _reference_step(arch, n)
    peak_lr, t = StepConfig().peak_lr, 1e-5
    for rank, rank_res in enumerate(_port_step(pools, arch, n, transport)):
        want = {"/".join(map(str, p)): v.numpy() for p, v in sharding.leaves(
            shard_params(ref["params"], rank, n, axis="expert"))}
        assert set(rank_res["params"]) == set(want)
        for name, w in want.items():
            d = np.abs(rank_res["params"][name] - w)
            assert d.mean() <= t * np.abs(w).mean(), (rank, name)
            assert d.max() <= 2 * peak_lr + t * np.abs(w).max(), (rank, name)


@pytest.mark.parametrize("arch,n,transport", STEP_CASES)
def test_ep_step_replicated_leaves_bitwise_equal(pools, arch, n, transport):
    res = _port_step(pools, arch, n, transport)
    names = set(res[0]["replicated"])
    assert {"embed", "layers/0/moe/router", "layers/1/attn/wq"} <= names
    assert not any(name.endswith(("moe/w_up", "moe/w_down"))
                   for name in names)
    for rank_res in res[1:]:
        assert rank_res["replicated"] == res[0]["replicated"]
    # the expert shards differ from rank to rank
    assert not np.array_equal(res[0]["params"]["layers/0/moe/w_up"],
                              res[1]["params"]["layers/0/moe/w_up"])


def test_streamed_bucketed_step_equals_plain(pools):
    """The streamed exchange (2 chunks) and bucketed accumulation: the
    same metrics and parameters, bit for bit, as the plain EP step."""
    ref = _reference_step(GROK, 2)
    base = _port_step(pools, GROK, 2, "ring")
    res = pools[2].run(
        rank_tasks.train, GROK, steps=1, reduced=True, moe_transport="ring",
        moe_stream_chunks=2,
        step_overrides=dict(STEP_KW, microbatches=2,
                            grad_bucket_bytes=1 << 12),
        params_np=ref["params0"], batches=ref["batches"], return_params=True)
    for a, b in zip(res, base):
        assert a["metrics"] == b["metrics"]
        for name in a["params"]:
            np.testing.assert_array_equal(a["params"][name],
                                          b["params"][name])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n,transport", [(LLAMA4, 2, "ring"),
                                              (GROK, 4, "xla")])
def test_ep_decode_matches_reference_and_dense_combine(pools, arch, n,
                                                       transport):
    """Bulk prefill, then 4 decode steps at EP: each step's logits against
    the reference's decode with its EP decode runner (``decode=True``) on
    ``("expert", n)``, and against the port's dense-combine decode, fed
    the reference's greedy tokens.  The reference's init: a std-0.3 draw
    takes the logits to ~9, where the port's and the reference's dense
    paths already differ by ~2e-5 in fp32 (their sums in other orders)."""
    ref_cfg, cfg = _cfg(arch)
    p_np = _np(ref_model.init_params(ref_cfg, jax.random.PRNGKey(5)))
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 6))
    steps = 4
    runner = _ref_runner(ref_cfg, n, "ring", decode=True)
    ref_p = jax.tree.map(jnp.asarray, p_np)
    cache, logits = ref_prefill.prefill(ref_cfg, ref_p, jnp.asarray(prompts),
                                        cache_len=6 + steps)
    step = jax.jit(lambda c, t: ref_decode.decode_step(
        ref_cfg, ref_p, c, t, moe_runner=runner))
    want, feed = [np.asarray(logits)], []
    for _ in range(steps):
        feed.append(np.asarray(jnp.argmax(want[-1], -1)))
        cache, logits = step(cache, jnp.asarray(feed[-1], jnp.int32))
        want.append(np.asarray(logits))
    assert len({tuple(f) for f in np.stack(feed, 1)}) > 1   # rows differ

    res = pools[n].run(rank_tasks.ep_serve, arch, prompts, steps=steps,
                       transport=transport, reduced=True, params_np=p_np,
                       feed=np.stack(feed))
    got = [np.concatenate([r["prefill_logits"] for r in res])] + [
        np.concatenate([r["logits"][k] for r in res]) for k in range(steps)]
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {k}")

    params = params_from_reference(p_np)
    c, lg = prefill.prefill(cfg, params, torch.from_numpy(prompts),
                            cache_len=6 + steps)
    dense = [lg.numpy()]
    for k in range(steps):
        c, lg = decode.decode_step(cfg, params, c, torch.tensor(feed[k]))
        dense.append(lg.numpy())
    for k, (g, w) in enumerate(zip(got, dense)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"dense-combine step {k}")


# ---------------------------------------------------------------------------
# presets and refusals
# ---------------------------------------------------------------------------


def test_ep_presets_equal_reference():
    assert EP_PRESET_NAMES == tuple(REF_EP_PRESETS)
    for name, preset in EP_PRESETS.items():
        assert dataclasses.asdict(preset) == dataclasses.asdict(
            REF_EP_PRESETS[name])
        got = get_ep_preset(name)
        policy = got.step.resolved_transport()
        assert (policy.moe, policy.moe_stream_chunks) == ("auto", 4)
        assert got.config.n_experts % got.expert_axis == 0
    with pytest.raises(KeyError):
        get_ep_preset("smollm-360m-ep")


def _group(size, rank=0):
    return Group(rank=rank, size=size, device=torch.device("cpu"))


@pytest.mark.parametrize("moe,exc,match", [
    ("auto", NotImplementedError, ROADMAP_AUTO),
    ("bidir", NotImplementedError, ROADMAP_SUBSTRATE),
])
def test_unported_moe_transports_raise(moe, exc, match):
    """A preset's own ``auto`` and the ``bidir`` transport raise when the
    step is built, naming their ROADMAP items."""
    _, cfg = _cfg(GROK)
    scfg = StepConfig(transport=TransportPolicy(moe=moe))
    with pytest.raises(exc, match=re.escape(match)):
        build_train_step(cfg, _group(2), scfg)
    preset = get_ep_preset("grok-1-314b-ep")
    with pytest.raises(NotImplementedError, match=re.escape(ROADMAP_AUTO)):
        build_train_step(cfg, _group(4), preset.step)


def test_data_axis_and_indivisible_batches_raise():
    _, cfg = _cfg(GROK)
    scfg = StepConfig(microbatches=2, **STEP_KW)
    # the data axis trains (tests/test_torch_train_mesh.py); a MoE model
    # on a model line (TP inside the expert region) does not
    with pytest.raises(NotImplementedError, match="item 7.5"):
        build_train_step(cfg, as_grid(_group(2), "model"), scfg)
    with pytest.raises(ValueError, match="do not split over 3"):
        build_train_step(cfg, _group(3), scfg)     # 4 experts over 3
    # 6 rows in 2 microbatches of 3: 3 rows do not split over 2 ranks,
    # refused before any collective
    group = _group(2)
    params, opt = build_init(cfg, group, scfg)(0)
    step = build_train_step(cfg, group, scfg)
    batch = {"tokens": torch.zeros(6, 8, dtype=torch.long),
             "labels": torch.zeros(6, 8, dtype=torch.long)}
    with pytest.raises(ValueError, match="batch 3 does not split"):
        step(params, opt, batch, 0)
    assert split_rows(8, _group(4, rank=2)) == slice(4, 6)
    with pytest.raises(ValueError, match="batch 5"):
        split_rows(5, _group(2))
