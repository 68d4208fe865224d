"""Atomic, resumable checkpoints (``repro.checkpoint.checkpoint``), in the
reference's on-disk format, so either package reads what the other wrote.

Write protocol (crash-safe at every point):
  1. serialize every leaf to ``<dir>/step_%08d.tmp/leaf_%05d.npy``
  2. write ``manifest.json`` (``step``, ``time``, ``extra`` and, a leaf,
     its ``name``, ``file``, ``shape`` and logical ``dtype``)
  3. fsync every file, then the directory
  4. atomic ``rename(step_K.tmp -> step_K)``: the commit point
  5. point the ``latest`` symlink at it (best effort: readers scan the
     step directories, never the link; the reference's docstring names
     this step and its code skips it)

A reader only ever sees committed checkpoints: ``step_K`` exists whole or
not at all, and a ``.tmp`` directory is never read.  ``keep_last`` old
checkpoints are removed after a commit, never before.

Leaf names are tree paths joined by ``/`` (dict keys, list indices), the
names the reference's ``tree_flatten_with_path`` gives the same tree.
bf16 leaves are stored as a ``uint16`` view with ``"bfloat16"`` as their
logical dtype (numpy has no bf16; this module keeps its own copy of that
view).  Python numbers in a tree (AdamW's ``step``) are stored as 0-d
arrays and restored as numbers.  Restore places the tensors on the
caller's device, or copies them into the template's own tensors
(``into``); ``cut`` restores a rank's part of each logical leaf (a grid's
shard, ``runtime/trainer.py``), reading the leaf through a memory map.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.dist.sharding import leaves, map_leaves

#: the 16-bit float stored as a same-width integer view
_BF16 = "bfloat16"


def _name(path) -> str:
    return "/".join(str(k) for k in path)


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, logical: str) -> torch.Tensor:
    if not arr.flags.writeable:         # a memory map: read it
        arr = np.array(arr)
    if logical == _BF16:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != logical:
        raise ValueError(f"stored dtype {arr.dtype} for logical dtype "
                         f"{logical!r}: not a view this module reads")
    return torch.from_numpy(arr)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _point_latest(directory: str, final: str) -> None:
    link = os.path.join(directory, "latest")
    tmp = link + ".tmp"
    try:
        if os.path.lexists(tmp):
            os.remove(tmp)
        os.symlink(os.path.basename(final), tmp)
        os.replace(tmp, link)
    except OSError:
        pass      # best effort: nothing reads the link to restore


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` as ``<directory>/step_%08d`` and return its path.  A
    step already committed is left as it is (an interval save followed by
    the final save at the same step)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(os.path.join(final, "manifest.json")):
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: Dict[str, Any] = {"step": step, "time": time.time(),
                                "extra": extra or {}, "leaves": []}
    for i, (path, leaf) in enumerate(leaves(tree)):
        arr, logical = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"name": _name(path), "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    os.rename(tmp, final)          # commit point
    _fsync_dir(directory)
    _point_latest(directory, final)
    return final


def list_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """Committed checkpoints as sorted ``(step, path)``."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in sorted(os.listdir(directory)):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name,
                                           "manifest.json")):
                out.append((int(name[5:]), os.path.join(directory, name)))
    return sorted(out)


def load_checkpoint(directory: str, template: Any, *,
                    step: Optional[int] = None,
                    device: DeviceLike = None,
                    cut: Optional[Callable[[Any, np.ndarray],
                                           np.ndarray]] = None,
                    into: bool = False) -> Tuple[Any, Dict[str, Any]]:
    """Restore the latest committed checkpoint (or ``step``) into the
    structure of ``template``, a tree of tensors and numbers.  Returns
    (tree, manifest).  Each tensor comes back with the stored dtype and
    bits, on ``device`` (default: the template leaf's device), or with
    ``into`` copied into the template's tensor, which comes back (a
    stored dtype other than the template's raises: a copy would round
    it); a number comes back as the template's type.  ``cut(path, array)``
    takes the stored (logical) array, read through a memory map, to the
    part of it this template holds."""
    ckpts = list_checkpoints(directory)
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    if step is None:
        step, path = ckpts[-1]
    else:
        match = [p for s, p in ckpts if s == step]
        if not match:
            raise FileNotFoundError(f"step {step} not in {directory}")
        path = match[0]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}

    def restore(p, leaf):
        name = _name(p)
        entry = by_name.get(name)
        if entry is None:
            raise KeyError(f"leaf {name!r} missing from checkpoint {path}")
        arr = np.load(os.path.join(path, entry["file"]),
                      mmap_mode="r" if cut is not None else None)
        if cut is not None:
            arr = cut(p, arr)
        t = _from_numpy(arr, entry["dtype"])
        want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != "
                             f"template {want}")
        if not isinstance(leaf, torch.Tensor):
            return type(leaf)(t.item())
        if into:
            if t.dtype != leaf.dtype:
                raise ValueError(f"{name}: checkpoint dtype {t.dtype} != "
                                 f"template {leaf.dtype}")
            return leaf.copy_(t)
        return t.to(leaf.device if device is None else device)

    return map_leaves(restore, template), manifest


@dataclasses.dataclass
class CheckpointManager:
    """Periodic and preemption checkpoints with GC of old steps."""

    directory: str
    interval: int = 100
    keep_last: int = 3

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.interval == 0

    def save(self, step: int, tree: Any, *, extra=None) -> str:
        path = save_checkpoint(self.directory, step, tree, extra=extra)
        self._gc()
        return path

    def restore_or_none(self, template: Any, device: DeviceLike = None,
                        **kw):
        """:func:`load_checkpoint` of the latest step (``kw``: its
        ``cut`` and ``into``), or None when there is none."""
        try:
            return load_checkpoint(self.directory, template, device=device,
                                   **kw)
        except FileNotFoundError:
            return None

    def latest_step(self) -> Optional[int]:
        ckpts = list_checkpoints(self.directory)
        return ckpts[-1][0] if ckpts else None

    def _gc(self) -> None:
        for _, path in list_checkpoints(self.directory)[: -self.keep_last]:
            shutil.rmtree(path, ignore_errors=True)


__all__ = ["CheckpointManager", "list_checkpoints", "load_checkpoint",
           "save_checkpoint"]
