"""The port's continuous-batching server against the reference server.

The CI serve recipe (6 requests, prompt 12, max-new 6, max-batch 2,
chunk 4, one arrival every 2 steps) runs through the reference ``Server``
on a one-device mesh and through the port's ``Server`` on the CPU, with
the same parameters and prompts, contiguous, paged (block 4) and bulk; the
emitted tokens must be identical.  smollm-360m is the main path;
h2o-danube-1.8b's reduced window (8) makes every 12-token prompt wrap the
ring buffer during prefill and decode.  Parameters are drawn with numpy at std
0.3 — at the default 0.02 init every request repeats one token, and token
identity would prove little.

``BlockPool`` is also driven through one random operation sequence beside
the reference's pool: the counts agree after every operation and
conservation holds throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.launch.mesh import make_host_mesh
from repro.models.model import init_params as ref_init_params
from repro.runtime import server as ref_server
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config
from repro_torch.runtime import server

RECIPE = dict(requests=6, prompt_len=12, max_new=6, max_batch=2, chunk=4,
              every=2)
MODES = {"contiguous": dict(prefill_chunk=4),
         "paged": dict(prefill_chunk=4, paged=True, block_size=4),
         "bulk": dict(prefill_chunk=None)}


def _std03_params(cfg, seed=0):
    """The reference's parameter pytree shape, drawn with numpy: std 0.3
    matrices, norm scales 1 + N(0, 0.1)."""
    shapes = jax.eval_shape(lambda k: ref_init_params(cfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _prompts(cfg, n, length, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=length) for _ in range(n)]


def _shared_prefix_prompts(cfg, n=5, shared=8, tail=4, seed=2):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, size=shared)
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                 size=tail)])
            for _ in range(n)]


def _srv_kw(mode):
    return dict(max_batch=RECIPE["max_batch"], max_seq=256,
                max_new_tokens=RECIPE["max_new"], **MODES[mode])


def _tokens(srv):
    return {r.rid: list(r.out_tokens) for r in srv.done}


def _setup(name):
    cfg_ref = ref_get_config(name).reduced()
    np_params = _std03_params(cfg_ref)
    return (cfg_ref, jax.tree.map(jnp.asarray, np_params),
            get_config(name).reduced(), params_from_reference(np_params))


@pytest.fixture(scope="module", params=["smollm-360m", "h2o-danube-1.8b"])
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def smollm():
    return _setup("smollm-360m")


def _run(drive, srv, prompts):
    drive(srv, prompts, RECIPE["every"])
    return _tokens(srv)


@pytest.fixture(scope="module")
def reference_tokens(setup):
    """One reference run per mode, shared by the tests."""
    cfg_ref, params_ref, cfg, _ = setup
    mesh = make_host_mesh(1, 1)
    prompts = _prompts(cfg, RECIPE["requests"], RECIPE["prompt_len"])
    out = {}
    for mode in MODES:
        srv = ref_server.Server(cfg_ref, params_ref, mesh,
                                srv=ref_server.ServerConfig(**_srv_kw(mode)))
        out[mode] = _run(ref_server.drive_arrivals, srv, prompts)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_tokens_equal_reference(setup, reference_tokens, mode):
    _, _, cfg, params = setup
    prompts = _prompts(cfg, RECIPE["requests"], RECIPE["prompt_len"])
    srv = server.Server(cfg, params, server.ServerConfig(**_srv_kw(mode)),
                        device="cpu")
    got = _run(server.drive_arrivals, srv, prompts)
    assert got == reference_tokens[mode]
    assert len(got) == RECIPE["requests"]
    assert all(len(t) == RECIPE["max_new"] for t in got.values())
    # the parameters make the requests disagree, so identity means something
    assert len({tuple(t) for t in got.values()}) > 1
    st = srv.stats()
    assert st["admission_mode"] == ("bulk" if mode == "bulk" else "chunked(4)")
    assert st["prefill_chunks"] == RECIPE["requests"] * (
        1 if mode == "bulk" else 3)


def test_prefix_hits_keep_tokens(smollm):
    """Shared prompt prefixes: the paged server admits the prefix once and
    resumes prefill after it; tokens equal the contiguous server's."""
    _, _, cfg, params = smollm
    prompts = _shared_prefix_prompts(cfg)
    outs, servers = {}, {}
    for mode in ("contiguous", "paged"):
        kw = dict(_srv_kw(mode), max_seq=32)
        srv = server.Server(cfg, params, server.ServerConfig(**kw),
                            device="cpu")
        for p in prompts:
            srv.submit(p)
        srv.run()
        outs[mode], servers[mode] = _tokens(srv), srv
    assert outs["paged"] == outs["contiguous"]
    assert servers["paged"].prefix_hits > 0
    servers["paged"].pool.check_conservation()


def test_cancel_mid_prefill_reclaims_blocks(smollm):
    _, _, cfg, params = smollm
    srv = server.Server(cfg, params, server.ServerConfig(**_srv_kw("paged")),
                        device="cpu")
    free0 = srv.pool.free_blocks
    rid = srv.submit(_prompts(cfg, 1, 12)[0])
    srv.step()                       # admitted, first chunk run
    assert srv.slots[0] is not None and srv.slots[0].phase == "prefill"
    assert srv.cancel(rid)
    assert srv.pool.free_blocks == free0 and srv.slots[0] is None
    assert not srv.cancel(rid)
    srv.pool.check_conservation()


def test_launcher_paged_equals_contiguous(tmp_path):
    """The CI serve smoke through the port's launcher on the CPU: the
    paged run's dumped tokens equal the contiguous run's."""
    from repro_torch.launch import serve

    args = ["--device", "cpu", "--requests", "6", "--prompt-len", "12",
            "--max-new", "6", "--max-batch", "2", "--prefill-chunk", "4",
            "--arrive-every", "2"]
    dumps = []
    for extra in ([], ["--paged", "--block-size", "4"]):
        path = tmp_path / f"tok{len(extra)}.json"
        srv = serve.main(args + extra + ["--dump-tokens", str(path)])
        assert len(srv.done) == 6
        dumps.append(path.read_text())
    assert dumps[0] == dumps[1]


MAMBA2_RECIPE = dict(requests=4, prompt_len=12, max_new=6, max_batch=2)
MAMBA2_MODES = {"chunked": 4, "bulk": None}


def _mamba2_params(cfg, seed=0):
    """std 0.3 weight matrices as :func:`_std03_params`, but the SSD decay
    and skip vectors (``a_log``, ``dt_bias``, ``d_skip``) keep the
    reference's init, so the decays stay in the model's range."""
    shapes = jax.eval_shape(lambda k: ref_init_params(cfg, k),
                            jax.random.PRNGKey(0))
    fixed = jax.tree.map(np.asarray, ref_init_params(cfg,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = path[-1].key
        if key in ("a_log", "dt_bias", "d_skip"):
            return fixed["layers"]["mamba"][key]
        if key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def mamba2_reference():
    """The CI chunk-carry recipe for mamba2 (4 requests, prompt 12,
    max-new 6, max-batch 2, all submitted up front) through the reference
    server, chunked (chunk 4, which rounds up to ssm_chunk 8) and bulk."""
    cfg_ref = ref_get_config("mamba2-2.7b").reduced()
    np_params = _mamba2_params(cfg_ref)
    params_ref = jax.tree.map(jnp.asarray, np_params)
    prompts = _prompts(cfg_ref, MAMBA2_RECIPE["requests"],
                       MAMBA2_RECIPE["prompt_len"])
    mesh = make_host_mesh(1, 1)
    out = {}
    for mode, chunk in MAMBA2_MODES.items():
        srv = ref_server.Server(cfg_ref, params_ref, mesh,
                                srv=ref_server.ServerConfig(
                                    **_mamba2_srv_kw(chunk)))
        for p in prompts:
            srv.submit(p)
        srv.run()
        out[mode] = _tokens(srv)
    return np_params, prompts, out


def _mamba2_srv_kw(chunk):
    return dict(max_batch=MAMBA2_RECIPE["max_batch"], max_seq=64,
                max_new_tokens=MAMBA2_RECIPE["max_new"], prefill_chunk=chunk)


@pytest.mark.parametrize("mode", list(MAMBA2_MODES))
def test_mamba2_tokens_equal_reference(mamba2_reference, mode):
    """The port's mamba2 server emits the reference server's tokens, and
    chunked and bulk admission emit the same tokens in both packages."""
    np_params, prompts, ref_tokens = mamba2_reference
    assert ref_tokens["chunked"] == ref_tokens["bulk"]
    cfg = get_config("mamba2-2.7b").reduced()
    srv = server.Server(cfg, params_from_reference(np_params),
                        server.ServerConfig(
                            **_mamba2_srv_kw(MAMBA2_MODES[mode])),
                        device="cpu")
    for p in prompts:
        srv.submit(p)
    srv.run()
    got = _tokens(srv)
    assert got == ref_tokens[mode]
    assert len(got) == MAMBA2_RECIPE["requests"]
    assert len({tuple(t) for t in got.values()}) > 1
    st = srv.stats()
    assert st["admission_mode"] == ("chunked(8)" if mode == "chunked"
                                    else "bulk")
    # prompt 12 at an effective chunk of 8: two chunks per request
    assert st["prefill_chunks"] == MAMBA2_RECIPE["requests"] * (
        2 if mode == "chunked" else 1)
    with pytest.raises(ValueError, match="paged"):
        server.Server(cfg, params_from_reference(np_params),
                      server.ServerConfig(paged=True), device="cpu")


@pytest.fixture(scope="module")
def zamba2_reference():
    """mamba2's recipe for the zamba2 hybrid through the reference server,
    chunked (chunk 4, rounded up to ssm_chunk 8) and bulk: the Mamba-2
    layers' decays and skips keep the reference's init, every other
    matrix is std 0.3 (the shared blocks' too)."""
    cfg_ref = ref_get_config("zamba2-7b").reduced()
    np_params = _mamba2_params(cfg_ref)
    params_ref = jax.tree.map(jnp.asarray, np_params)
    prompts = _prompts(cfg_ref, MAMBA2_RECIPE["requests"],
                       MAMBA2_RECIPE["prompt_len"])
    mesh = make_host_mesh(1, 1)
    out = {}
    for mode, chunk in MAMBA2_MODES.items():
        srv = ref_server.Server(cfg_ref, params_ref, mesh,
                                srv=ref_server.ServerConfig(
                                    **_mamba2_srv_kw(chunk)))
        for p in prompts:
            srv.submit(p)
        srv.run()
        out[mode] = _tokens(srv)
    return np_params, prompts, out


@pytest.mark.parametrize("mode", list(MAMBA2_MODES))
def test_zamba2_tokens_equal_reference(zamba2_reference, mode):
    """The port's server emits the reference server's tokens for the
    hybrid, chunked and bulk; its cache has no paged layout."""
    np_params, prompts, ref_tokens = zamba2_reference
    cfg = get_config("zamba2-7b").reduced()
    params = params_from_reference(np_params)
    srv = server.Server(cfg, params, server.ServerConfig(
        **_mamba2_srv_kw(MAMBA2_MODES[mode])), device="cpu")
    for p in prompts:
        srv.submit(p)
    srv.run()
    got = _tokens(srv)
    assert got == ref_tokens[mode]
    assert len(got) == MAMBA2_RECIPE["requests"]
    assert all(len(t) == MAMBA2_RECIPE["max_new"] for t in got.values())
    assert len({tuple(t) for t in got.values()}) > 1
    st = srv.stats()
    assert st["admission_mode"] == ("chunked(8)" if mode == "chunked"
                                    else "bulk")
    assert st["prefill_chunks"] == MAMBA2_RECIPE["requests"] * (
        2 if mode == "chunked" else 1)
    with pytest.raises(ValueError, match="paged"):
        server.Server(cfg, params, server.ServerConfig(paged=True),
                      device="cpu")


def test_block_pool_random_ops_match_reference():
    rng = np.random.default_rng(0)
    ours, ref = server.BlockPool(24, reserved=3), ref_server.BlockPool(
        24, reserved=3)
    held = []                        # block ids of each live claim
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(1, 6))
            if ours.can_cover(n):
                bids = ours.alloc(n)
                assert ref.alloc(n) == bids
                held.append(bids)
            else:
                with pytest.raises(MemoryError):
                    ours.alloc(n)
        elif op == 1 and held:
            bids = held.pop(int(rng.integers(0, len(held))))
            ours.release(bids)
            ref.release(bids)
        elif op == 2 and held:
            bids = held[int(rng.integers(0, len(held)))]
            key = bytes([int(rng.integers(0, 6))])
            ours.cache_insert(key, bids)
            ref.cache_insert(key, bids)
        elif op == 3:
            key = bytes([int(rng.integers(0, 6))])
            bids = ours.cache_lookup(key)
            assert ref.cache_lookup(key) == bids
            if bids is not None:
                held.append(bids)
        ours.check_conservation()
        assert (ours.free_blocks, ours.live_blocks, ours.cached_entries,
                ours.evictions) == (ref.free_blocks, ref.live_blocks,
                                    ref.cached_entries, ref.evictions)
    pool = server.BlockPool(4, reserved=1)
    bids = pool.alloc(2)
    pool.release(bids)
    with pytest.raises(ValueError, match="double free"):
        pool.release(bids[:1])
