"""Build and load the port's hand-written CUDA kernels.

Each kernel source ``<dir>/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``.  Headers shared by several kernels (``kernels/include/``, e.g.
``hopper.cuh``: cp.async, wgmma and its descriptors) are found through
``-I``; no header from outside the checkout is used (no CUTLASS).
Libraries land in ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the flags, of every source in the kernel's
``csrc/`` and of every header it includes from the checkout, so a changed
source or header rebuilds and an unchanged one loads at once.  Nothing
builds at import: the first launch on a CUDA tensor builds, and
:func:`build` lets a caller build several sources at once, one ``nvcc``
process each, all in parallel.

There is no interpret mode and no override: a kernel's wrapper runs the
plain PyTorch version for CPU tensors and launches the kernel (or raises)
for CUDA tensors — the tensor's device alone decides.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
:meth:`CudaKernel.check` raises on a nonzero code, so a refused launch
(too many threads, too much shared memory) cannot pass unnoticed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

#: root of the checkout (``src/repro_torch/kernels/common.py`` → 3 up)
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
KERNELS_DIR = Path(__file__).resolve().parent
INCLUDE_DIR = KERNELS_DIR / "include"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels are "
            "built from source at first use")
    return path


def source_of(name: str) -> Path:
    """``name`` → ``kernels/<name>/csrc/<name>.cu``, and ``<dir>/<name>``
    → ``kernels/<dir>/csrc/<name>.cu`` (a second source of one kernel's
    directory, e.g. ``ssd/ssd_bwd``)."""
    folder, _, stem = name.rpartition("/")
    return KERNELS_DIR / (folder or stem) / "csrc" / f"{stem}.cu"


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def included_headers(src: Path) -> List[Path]:
    """Every header ``src`` includes with quotes, directly or through
    another header, found beside the including file or in
    :data:`INCLUDE_DIR` (the ``-I`` of the build)."""
    seen: List[Path] = []
    todo = [src]
    while todo:
        f = todo.pop()
        for name in _INCLUDE.findall(f.read_text()):
            for d in (f.parent, INCLUDE_DIR):
                h = (d / name).resolve()
                if h.exists():
                    if h not in seen:
                        seen.append(h)
                        todo.append(h)
                    break
            else:
                raise FileNotFoundError(f"{f}: #include \"{name}\" not "
                                        f"found beside it or in {INCLUDE_DIR}")
    return sorted(seen)


def library_path(src: Path) -> Path:
    """Where the library of ``src`` lives: keyed by the compiler flags and
    the bytes of every source in its ``csrc/`` directory and of every
    header it includes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = [f for f in sorted(src.parent.iterdir())
             if f.suffix in (".cu", ".cuh", ".h")]
    for f in files + [f for f in included_headers(src) if f not in files]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Build the libraries of ``names`` that are missing, one ``nvcc`` per
    source, all started together.  Returns wall seconds per name built
    (0.0 when the library was already there).  Raises with ``nvcc``'s
    output when a build fails.  ``ptxas``'s register and shared-memory
    report is kept beside each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    started: Dict[str, tuple] = {}
    secs: Dict[str, float] = {}
    for name in names:
        src = source_of(name)
        out = library_path(src)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
               str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    errors: List[str] = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n"
                          f"{log}")
            continue
        Path(str(out) + ".log").write_text(log)
        os.replace(tmp, out)          # atomic: a reader never sees half a lib
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def current_stream(device) -> int:
    """The ``cudaStream_t`` of ``device``'s current stream, as an int:
    PyTorch's raw-stream query (``torch.cuda.current_stream`` builds a
    Stream object, several microseconds a launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(
        device.index if device.index is not None
        else torch.cuda.current_device())


def launch_on(device, fn, args) -> int:
    """``fn(*args, stream)`` with ``device`` current and its current
    stream: the launch of a C entry point.  The device is switched only
    when it is not current already (a switch costs more than the launch)."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args, current_stream(device))
    with torch.cuda.device(device):
        return fn(*args, current_stream(device))


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when autograd is recording and an input of a forward-only
    kernel (flash attention, the DLA matmul) requires grad: its output
    would carry no ``grad_fn``, and the gradient would stop there without
    a word.  A caller that trains routes around the kernel (training
    attends through ``models.layers.blockwise_attention``); the SSD scan
    has a backward of its own (``kernels/ssd/ops.py``)."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad while autograd records; call it under "
            f"torch.no_grad() or on inputs that need no gradient")


class CudaKernel:
    """One kernel library: loaded lazily, with a launch count.

    ``launches`` is incremented by the kernel's wrapper exactly where it
    launches the kernel, and nowhere else — a run can read it to show that
    its work went through the kernel and not the plain version.
    """

    def __init__(self, name: str, entry: str, argtypes: List[type]):
        self.name, self.entry, self.argtypes = name, entry, argtypes
        self.launches = 0
        self._fn = None
        self._lib = None

    def symbol(self, entry: str, argtypes: List[type]):
        """C entry point ``entry`` of the library (an ``int`` result),
        building and loading the library on first use."""
        if self._lib is None:
            build([self.name])
            self._lib = ctypes.CDLL(str(library_path(source_of(self.name))))
        fn = getattr(self._lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def fn(self):
        """The launch entry point, building and loading the library on
        first use."""
        if self._fn is None:
            self._fn = self.symbol(self.entry, self.argtypes)
        return self._fn

    def check(self, rc: int):
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with cudaError {rc}")

    def ptxas_report(self) -> str:
        log = Path(str(library_path(source_of(self.name))) + ".log")
        return log.read_text() if log.exists() else ""


__all__ = ["BUILD_DIR", "CudaKernel", "INCLUDE_DIR", "NVCC_FLAGS", "build",
           "current_stream", "included_headers", "launch_on", "library_path",
           "nvcc_path", "refuse_autograd", "source_of"]
