"""The port's DLA matmul against the reference's.

``repro_torch.kernels.matmul.matmul`` on CPU tensors runs its plain
version (``ref.py``); it is held to the reference's Pallas kernel
(``repro.kernels.matmul.matmul``, interpret mode on the CPU) and to its
oracle ``matmul_ref`` on the same numpy inputs: every activation with and
without a bias, the reference's test shapes, batched and ragged inputs,
fp32 and bf16 with ``out_dtype``.  Tolerances are the reference's kernel
tests': fp32 2e-5, bf16 2e-2 (absolute and relative).  The CUDA kernel
itself runs only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``); here its launcher is shown to refuse CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul import matmul as ref_matmul
from repro.kernels.matmul.ref import matmul_ref
from repro_torch.kernels.matmul import (
    ACTIVATIONS,
    MATMUL,
    PLAIN_CALLS,
    matmul,
    matmul_plain,
)
from repro_torch.kernels.matmul.ops import matmul_cuda

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(x, w, b=None, *, dtype="float32", out_dtype=None, **kw):
    """(port, reference kernel, reference oracle) outputs as fp32 numpy."""
    jd, td = _JNP[dtype], _TORCH[dtype]
    jx, jw = jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd)
    jb = None if b is None else jnp.asarray(b).astype(jd)
    tx, tw = torch.from_numpy(x).to(td), torch.from_numpy(w).to(td)
    tb = None if b is None else torch.from_numpy(b).to(td)
    jo = None if out_dtype is None else _JNP[out_dtype]
    to = None if out_dtype is None else _TORCH[out_dtype]
    got = matmul(tx, tw, tb, out_dtype=to, **kw)
    want_k = ref_matmul(jx, jw, jb, out_dtype=jo, **kw)
    want_r = matmul_ref(jx, jw, jb, out_dtype=jo, **kw)
    assert got.dtype == (to or td)
    assert tuple(got.shape) == want_k.shape
    return (got.float().numpy(), np.asarray(want_k.astype(jnp.float32)),
            np.asarray(want_r.astype(jnp.float32)))


def _close(got, *wants, tol):
    for want in wants:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n", [
    (128, 128, 128), (100, 200, 150), (256, 64, 512), (1, 7, 3),
    (384, 128, 128),
])
def test_reference_shapes(m, k, n):
    x, w = _inputs(m + k + n, (m, k), (k, n))
    _close(*_both(x, w), tol=TOL["float32"])


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_activations(act, with_bias):
    x, w, b = _inputs(3, (64, 96), (96, 80), (80,))
    _close(*_both(x, w, b if with_bias else None, activation=act),
           tol=TOL["float32"])


@pytest.mark.parametrize("dtype,out_dtype", [
    ("float32", None), ("float32", "bfloat16"), ("bfloat16", "float32"),
    ("bfloat16", None),
])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_dtypes(dtype, out_dtype, act):
    x, w, b = _inputs(4, (64, 64), (64, 48), (48,))
    tol = TOL["bfloat16" if "bfloat16" in (dtype, out_dtype) else "float32"]
    _close(*_both(x, w, b, dtype=dtype, out_dtype=out_dtype,
                  activation=act), tol=tol)


def test_batched():
    x, w, b = _inputs(5, (3, 40, 64), (64, 32), (32,))
    got, want_k, want_r = _both(x, w, b, activation="gelu")
    assert got.shape == (3, 40, 32)
    _close(got, want_k, want_r, tol=TOL["float32"])


@pytest.mark.parametrize("m,k,n", [(77, 130, 45), (33, 1, 65), (2, 300, 1)])
def test_ragged(m, k, n):
    x, w, b = _inputs(6 + m, (m, k), (k, n), (n,))
    _close(*_both(x, w, b, activation="relu2"), tol=TOL["float32"])


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu's default is the tanh approximation; the erf form
    would miss the fp32 tolerance."""
    x, w = _inputs(7, (32, 64), (64, 32))
    x *= 3
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = matmul(tx, tw, activation="gelu").numpy()
    want = np.asarray(matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                 activation="gelu"))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    erf = torch.nn.functional.gelu(tx @ tw).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_bias_added_in_fp32_before_the_activation():
    """A bf16 bias is widened, added to the fp32 product, then the
    activation runs, then one cast: the same bits as the oracle."""
    x, w, b = _inputs(8, (16, 32), (32, 24), (24,))
    tb = torch.from_numpy(b * 100).to(torch.bfloat16)
    jb = jnp.asarray(b * 100).astype(jnp.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = matmul(xb, wb, tb, activation="silu", out_dtype=torch.float32)
    want = matmul_ref(jnp.asarray(x).astype(jnp.bfloat16),
                      jnp.asarray(w).astype(jnp.bfloat16), jb,
                      activation="silu", out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    x, w = _inputs(9, (8, 16), (16, 4))
    before, launches = PLAIN_CALLS["matmul"], MATMUL.launches
    got = matmul(torch.from_numpy(x), torch.from_numpy(w), activation="relu")
    assert PLAIN_CALLS["matmul"] == before + 1
    assert MATMUL.launches == launches
    torch.testing.assert_close(got, matmul_plain(
        torch.from_numpy(x), torch.from_numpy(w), activation="relu"))


def test_kernel_entry_needs_cuda():
    """The kernel's launcher never runs on the CPU, and the wrapper takes
    no device but the CPU's (plain) and the card's (kernel)."""
    x, w = torch.zeros(4, 8), torch.zeros(8, 6)
    launches = MATMUL.launches
    with pytest.raises(ValueError, match="CUDA"):
        matmul_cuda(x, w)
    with pytest.raises(ValueError, match="device"):
        matmul(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="activation"):
        matmul_plain(x, w, activation="tanh")
    assert MATMUL.launches == launches
