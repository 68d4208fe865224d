"""The train steps under every transport policy the reference accepts,
against the reference's steps with the same policy.

* the TP step on reduced ``h2o-danube-1.8b`` in fp32 at TP 4 under
  ``tp="ring"``, ``"bidir"`` and ``"auto"``, and at TP 2 under ``"bidir"``
  (its n == 2 fallback to one ring), fed the reference's parameters and
  batches, against ``build_train_step`` with the same
  ``TransportPolicy`` on a ``(1, tp)`` host mesh for 2 steps, at the
  tolerances and parameter rule of ``tests/test_torch_train.py``
  ((loss, grad_norm) 1e-5 relative; every leaf's mean |Δ| within 1e-5 of
  its mean magnitude, max |Δ| within 2·peak_lr + 1e-5 of its largest);
  replicated leaves bitwise equal across ranks; every TP edge on the
  policy's family (``auto``: the family ``matmul_schedule`` picks on the
  CPU at the edge's bytes and modeled time);
* reduced ``grok-1-314b``'s EP step at EP 4 under its preset's own
  policy (``moe="auto"``, streamed in 4 chunks) against the reference's
  step with the same policy on an ``("expert", 4)`` mesh;
* a data 2 × model 2 grid step on reduced h2o under
  ``cross_pod="auto"`` against the reference's step on
  ``make_host_mesh(2, 2)`` (which leaves the data axis to GSPMD and never
  reads ``cross_pod``: the oracle of ``tests/test_torch_train_mesh.py``).

One gloo world per size is spawned for the module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.presets import get_ep_preset as ref_get_ep_preset
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.data.pipeline import batch_specs
from repro.dist.steps import StepConfig as RefStepConfig
from repro.dist.steps import TransportPolicy as RefTransportPolicy
from repro.dist.steps import build_init as ref_build_init
from repro.dist.steps import build_train_step as ref_build_train_step
from repro.launch.mesh import make_host_mesh as ref_make_host_mesh
from repro_torch.bridge import shard_params
from repro_torch.configs import get_ep_preset
from repro_torch.core.conduit import Conduit
from repro_torch.dist import rank_tasks, sharding
from repro_torch.dist.group import Group, RankPool
from repro_torch.dist.steps import StepConfig

DENSE, GROK = "h2o-danube-1.8b", "grok-1-314b"
STEP_KW = dict(seq_chunk=8, warmup_steps=1)
T = 1e-5


@pytest.fixture(scope="module")
def pools():
    worlds = {n: RankPool(n, device="cpu") for n in (2, 4)}
    yield worlds
    for pool in worlds.values():
        pool.close()


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _run_reference(cfg, mesh, scfg, data, steps):
    """The reference's step on ``mesh``: initial params, batches, per-step
    metrics and the final params, as numpy."""
    bundle = ref_build_train_step(cfg, mesh, scfg, batch_specs(
        data.cfg.seq_len - 1, data.cfg.global_batch, cfg.vocab_size))
    params, opt = ref_build_init(cfg, mesh, scfg)[0](jax.random.PRNGKey(0))
    params0 = _np(params)
    batches, metrics = [], []
    for step in range(steps):
        batch = {k: np.asarray(v) for k, v in
                 data.global_batch(step).items()}
        batches.append(batch)
        params, opt, m = bundle.fn(params, opt, batch, jnp.int32(step))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")
                        + (("moe_aux",) if "moe_aux" in m else ())})
    return dict(params0=params0, batches=batches, metrics=metrics,
                params=_np(params))


def _check_rule(ref_params, res, axis):
    peak_lr = StepConfig().peak_lr
    for r in res:
        inner, n = r["coords"][1], r["shape"][1]
        want = {"/".join(map(str, p)): v.numpy() for p, v in sharding.leaves(
            shard_params(ref_params, inner, n, axis=axis,
                         scheme=r["scheme"]))}
        assert set(r["params"]) == set(want)
        for name, w in want.items():
            d = np.abs(r["params"][name] - w)
            assert d.mean() <= T * np.abs(w).mean(), (r["coords"], name)
            assert d.max() <= 2 * peak_lr + T * np.abs(w).max(), \
                (r["coords"], name)


def _check_metrics(ref, res, keys=("loss", "grad_norm")):
    for r in res:
        for got, want in zip(r["metrics"], ref["metrics"]):
            for key in keys:
                np.testing.assert_allclose(got[key], want[key], rtol=T,
                                           atol=0)


def _check_replicated(res):
    for r in res[1:]:
        assert r["replicated"] == res[0]["replicated"]


# ---------------------------------------------------------------------------
# the TP step under ring, bidir and auto
# ---------------------------------------------------------------------------

TP_CASES = [(4, "ring"), (4, "bidir"), (4, "auto"), (2, "bidir")]
_RUNS = {}


def _tp_runs(pools, tp, transport):
    if (tp, transport) not in _RUNS:
        cfg = ref_get_config(DENSE).reduced()
        scfg = RefStepConfig(transport=RefTransportPolicy(tp=transport),
                             **STEP_KW)
        data = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=17, global_batch=2))
        ref = _run_reference(cfg, ref_make_host_mesh(data=1, model=tp),
                             scfg, data, steps=2)
        res = pools[tp].run(
            rank_tasks.train, DENSE, steps=2, reduced=True,
            tp_transport=transport, step_overrides=STEP_KW,
            params_np=ref["params0"], batches=ref["batches"],
            return_params=True)
        _RUNS[tp, transport] = ref, res
    return _RUNS[tp, transport]


@pytest.mark.parametrize("tp,transport", TP_CASES)
def test_tp_step_matches_reference(pools, tp, transport):
    ref, res = _tp_runs(pools, tp, transport)
    _check_metrics(ref, res)
    _check_rule(ref["params"], res, "model")
    _check_replicated(res)


@pytest.mark.parametrize("tp,transport", TP_CASES)
def test_tp_edges_take_the_policys_family(pools, tp, transport):
    """Each TP edge ran the family the policy names; under ``auto`` the
    family ``matmul_schedule`` picks on the CPU at that edge's (bytes,
    modeled time), and the direction ``matmul_bidirectional`` picks."""
    _, res = _tp_runs(pools, tp, transport)
    cpu = Conduit(axis=Group(rank=0, size=tp, device=torch.device("cpu")),
                  transport=transport)
    for r in res:
        for step in r["edges"]:
            assert step, "no TP edge ran"
            for (op, size, tc, family, bidir), calls in step:
                assert calls > 0
                assert family == cpu.matmul_schedule(op, size, tc)
                if transport != "auto":
                    assert family == transport
                    assert bidir == (transport == "bidir")


# ---------------------------------------------------------------------------
# the EP step under its preset's own policy
# ---------------------------------------------------------------------------


def test_ep_preset_policy_step_matches_reference(pools):
    preset, ref_preset = get_ep_preset(f"{GROK}-ep"), \
        ref_get_ep_preset(f"{GROK}-ep")
    n = preset.expert_axis
    policy = preset.step.resolved_transport()
    assert (policy.moe, policy.moe_stream_chunks, n) == ("auto", 4, 4)
    over = dict(seq_chunk=8, warmup_steps=2, total_steps=10)
    cfg = ref_get_config(GROK).reduced()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("expert",))
    data = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=17, global_batch=16))
    ref = _run_reference(cfg, mesh, dataclasses.replace(ref_preset.step,
                                                        **over), data, 1)
    res = pools[n].run(
        rank_tasks.train, GROK, steps=1, reduced=True,
        moe_transport=policy.moe, moe_stream_chunks=policy.moe_stream_chunks,
        step_overrides=over, params_np=ref["params0"],
        batches=ref["batches"], return_params=True)
    _check_metrics(ref, res, ("loss", "grad_norm", "moe_aux"))
    _check_rule(ref["params"], res, "expert")
    _check_replicated(res)


# ---------------------------------------------------------------------------
# the grid step with cross_pod="auto"
# ---------------------------------------------------------------------------


def test_grid_step_with_auto_cross_pod_matches_reference(pools):
    cfg = ref_get_config(DENSE).reduced()
    scfg = RefStepConfig(transport=RefTransportPolicy(tp="fused"),
                         **STEP_KW)
    data = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=17, global_batch=4))
    ref = _run_reference(cfg, ref_make_host_mesh(2, 2), scfg, data, 2)
    res = pools[4].run(
        rank_tasks.train, DENSE, steps=2, reduced=True, cross_pod="auto",
        step_overrides=STEP_KW, params_np=ref["params0"],
        batches=ref["batches"], return_params=True,
        grid=dict(data=2, model=2))
    _check_metrics(ref, res)
    _check_rule(ref["params"], res, "model")
    for r in res:
        assert r["line_stats"][0]["data"]["sent_bytes"] > 0
    by_inner = {}
    for r in res:
        by_inner.setdefault(r["coords"][1], []).append(r["digests"])
    assert all(d == ds[0] for ds in by_inner.values() for d in ds[1:])
