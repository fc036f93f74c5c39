"""Checkpointing: atomic, optionally async, in the reference's layout.

The port of ``src/repro/train/checkpoint.py``. Layout:
``<dir>/step_<N>/`` holds one ``.npy`` per leaf (the tree path joined
with ``'__'``) and ``manifest.json`` (step, leaf shapes and dtypes,
meta). Writes go to a tmp dir and an atomic rename, so a preemption
mid-write never corrupts the latest checkpoint, and only the newest
``keep`` are kept. The layout and the files are the reference's, so a
checkpoint that either package writes restores in the other (the train
state's ``step`` is a 0-d int32 leaf in both).

``restore(..., device=)`` returns torch tensors on ``device``; placing
the leaves sharded over a mesh (the reference's ``shardings=``) comes
with the multi-rank slice.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}__"))
        return out
    return {prefix[:-2]: tree}


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("__")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return root


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a numpy array; with ``copy``, one that shares no memory
    with the leaf (a CPU tensor's ``.numpy()`` is a view of it)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy).numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def save(ckpt_dir: str, step: int, state, *, meta: Optional[Dict] = None,
         keep: int = 3) -> str:
    flat = _flatten(state)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "meta": meta or {}}
    for path, leaf in flat.items():
        arr = _host(leaf)
        manifest["leaves"][path] = {"shape": list(arr.shape),
                                    "dtype": str(arr.dtype)}
        np.save(os.path.join(tmp, path + ".npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        (int(d.split("_")[1]), d)
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_")
    )
    for _, d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and os.path.exists(
            os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, *,
            device="cuda") -> Tuple[int, Any]:
    """Returns (step, state), every leaf a tensor on ``device``."""
    if step is None:
        step = latest_step(ckpt_dir)
        assert step is not None, f"no checkpoints in {ckpt_dir}"
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for path in manifest["leaves"]:
        arr = np.load(os.path.join(d, path + ".npy"))
        flat[path] = torch.from_numpy(arr).to(device)
    return step, _unflatten(flat)


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (one in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state, meta=None):
        self.wait()
        # a host copy taken now: the optimizer overwrites the state's
        # tensors in place while the thread writes
        host_state = tree_map(lambda x: _host(x, copy=True), state)

        def _run():
            save(self.ckpt_dir, step, host_state, meta=meta, keep=self.keep)

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
