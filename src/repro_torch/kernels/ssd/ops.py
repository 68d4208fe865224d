"""SSD scan wrapper: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors, and nothing in between.

``ssd`` checks device, dtypes, shapes and strides, allocates y and the
final state with ``torch.empty`` and launches ``csrc/ssd.cu`` on the
current stream.  x, b and c may be strided views (the model passes slices
of the conv output, whose row stride is the conv width) as long as their
last dim is contiguous; a ragged S is handled inside the kernel, so
nothing is padded or copied.  ``ssd_chunk_fed`` runs the scan over a
sequence delivered in segments, carrying the state from one call to the
next through ``init_state``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels.common import CudaKernel
from repro_torch.kernels.ssd.ref import ssd_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: dynamic shared memory one block may take on Hopper (227 KB)
SMEM_LIMIT = 232_448

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SSD = CudaKernel(
    "ssd", "repro_ssd_fwd",
    [_I] + [_P] * 9 + [_I] * 7 + [_L] * 12 + [_P])


def smem_bytes(chunk: int, n: int, p: int) -> int:
    """Shared memory of one block, as ``make_layout`` in ``csrc/ssd.cu``
    lays it out: fp32 B and C (chunk × (n+4)), X (chunk × (p+4)), the
    state (n × (p+4)), a weight strip (min(chunk, 32) × (chunk+4)) and
    three chunk-length vectors."""
    return 4 * (2 * chunk * (n + 4) + chunk * (p + 4) + n * (p + 4)
                + min(chunk, 32) * (chunk + 4) + 3 * chunk)


def ssd(
    x: torch.Tensor,                      # (B, S, H, P)
    dt: torch.Tensor,                     # (B, S, H) fp32
    a: torch.Tensor,                      # (H,) fp32
    b: torch.Tensor,                      # (B, S, G, N)
    c: torch.Tensor,                      # (B, S, G, N)
    d: torch.Tensor,                      # (H,) fp32
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,   # (B, H, N, P) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, N, P) fp32).  See :func:`~repro_torch.kernels.ssd.ref.ssd_plain`."""
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a, b, c, d, chunk=chunk,
                         init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"ssd: shapes x {tuple(x.shape)} b {tuple(b.shape)} "
                         f"c {tuple(c.shape)}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if b.shape[:2] != (bsz, s) or dt.shape != (bsz, s, h) \
            or a.shape != (h,) or d.shape != (h,):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} a {tuple(a.shape)} b "
                         f"{tuple(b.shape)} d {tuple(d.shape)}")
    if bsz == 0 or s == 0 or g == 0 or h % g:
        raise ValueError(f"ssd: batch {bsz}, seq {s}, heads {h}, groups {g}")
    if chunk <= 0 or chunk % 4 or n % 8 or p % 4:
        raise ValueError(f"ssd: chunk {chunk} and head dim {p} must be "
                         f"multiples of 4, state size {n} of 8")
    if smem_bytes(chunk, n, p) > SMEM_LIMIT:
        raise ValueError(f"ssd: chunk {chunk}, state {n}, head dim {p} need "
                         f"{smem_bytes(chunk, n, p)} B of shared memory, "
                         f"more than {SMEM_LIMIT}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd: x/b/c dtypes {x.dtype}, {b.dtype}, {c.dtype}; "
                        f"supported: float32 or bfloat16, alike")
    if dt.dtype != torch.float32 or a.dtype != torch.float32 \
            or d.dtype != torch.float32:
        raise TypeError(f"ssd: dt, a, d must be float32 ({dt.dtype}, "
                        f"{a.dtype}, {d.dtype})")
    if any(t.device != x.device for t in (dt, a, b, c, d)):
        raise ValueError("ssd: inputs on different devices")
    if x.stride(3) != 1 or b.stride(3) != 1 or c.stride(3) != 1:
        raise ValueError("ssd: the last dim of x, b and c must be contiguous")
    a, d = a.contiguous(), d.contiguous()
    if init_state is not None:
        if init_state.shape != (bsz, h, n, p) \
                or init_state.dtype != torch.float32 \
                or init_state.device != x.device \
                or not init_state.is_contiguous():
            raise ValueError(
                f"ssd: init_state must be a contiguous float32 "
                f"{(bsz, h, n, p)} tensor on {x.device}, got "
                f"{init_state.dtype} {tuple(init_state.shape)}")
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    fn = SSD.fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                b.data_ptr(), c.data_ptr(), d.data_ptr(),
                None if init_state is None else init_state.data_ptr(),
                y.data_ptr(), state.data_ptr(), bsz, s, h, g, n, p, chunk,
                x.stride(0), x.stride(1), x.stride(2),
                dt.stride(0), dt.stride(1), dt.stride(2),
                b.stride(0), b.stride(1), b.stride(2),
                c.stride(0), c.stride(1), c.stride(2), stream)
    SSD.check(rc)
    SSD.launches += 1
    return y, state


def ssd_chunk_fed(
    fetch: Callable[[int], Tuple[torch.Tensor, ...]],
    n_segments: int,
    a: torch.Tensor,
    d: torch.Tensor,
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan over a sequence delivered segment by segment: ``fetch(k)``
    returns segment ``k``'s ``(x, dt, b, c)``, and each segment's scan
    starts from the previous one's final state.  With every segment but
    the last a multiple of ``chunk``, the chunk walk is that of one
    :func:`ssd` call over the whole sequence.  (The reference overlaps the
    next fetch with the current scan; here the fetches are slices, and the
    loop runs them in turn.)  Returns (y (B, S_total, H, P), final state)."""
    if n_segments <= 0:
        raise ValueError("n_segments must be positive")
    ys, state = [], init_state
    for k in range(n_segments):
        x, dt, b, c = fetch(k)
        y, state = ssd(x, dt, a, b, c, d, chunk=chunk, init_state=state)
        ys.append(y)
    return torch.cat(ys, dim=1), state
