"""Checkpointing: atomic, optionally async, in the reference's layout.

The port of ``src/repro/train/checkpoint.py``. Layout:
``<dir>/step_<N>/`` holds one ``.npy`` per leaf (the tree path joined
with ``'__'``) and ``manifest.json`` (step, leaf shapes and dtypes,
meta). Writes go to a tmp dir and an atomic rename, so a preemption
mid-write never corrupts the latest checkpoint, and only the newest
``keep`` are kept. The layout and the files are the reference's, so a
checkpoint that either package writes restores in the other (the train
state's ``step`` is a 0-d int32 leaf in both).

``restore(..., device=)`` returns torch tensors on ``device``; with
``shardings=`` (a matching tree of ``NamedSharding``s on a mesh of the
running job, the reference's elastic restore) each leaf becomes a DTensor
of which each rank reads and keeps only its own block.

A state of DTensors is saved in the same files: every rank takes part in
gathering each full leaf (``full_tensor()``), rank 0 writes, and the ranks
meet at a barrier before ``save`` returns. So a checkpoint from 4 ranks
restores on 1 and in the JAX package, and theirs onto 4 ranks.
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


def _sharded(state) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for x in _flatten(state).values())


def _writer() -> bool:
    """Whether this process writes checkpoint files (rank 0 of a job)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a numpy array; with ``copy``, one that shares no memory
    with the leaf (a CPU tensor's ``.numpy()`` is a view of it). A DTensor
    is gathered whole first (a collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        leaf, copy = leaf.full_tensor(), False
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=copy).numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def save(ckpt_dir: str, step: int, state, *, meta: Optional[Dict] = None,
         keep: int = 3) -> str:
    final = os.path.join(ckpt_dir, f"step_{step}")
    if _sharded(state):
        host = {k: _host(v) for k, v in _flatten(state).items()}
        if _writer():
            _write(ckpt_dir, step, host, meta, keep)
        import torch.distributed as dist
        dist.barrier()
        return final
    return _write(ckpt_dir, step, _flatten(state), meta, keep)


def _write(ckpt_dir, step, flat, meta, keep) -> str:
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


def _placed(path: str, shape, sharding, device):
    """Leaf ``path`` (an ``.npy``) as a DTensor laid out by ``sharding``:
    only this rank's block is read from the file and put on ``device``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, pl = sharding.mesh, sharding.placements
    arr = np.load(path, mmap_mode="r")
    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), mesh, pl)
    block = arr[tuple(slice(o, o + n) for o, n in zip(offset, local))]
    t = torch.from_numpy(np.array(block)).to(device)  # a 0-d stays 0-d
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(tuple(shape),
                                                 device="meta").stride())


def restore(ckpt_dir: str, step: Optional[int] = None, *, shardings=None,
            device="cuda") -> Tuple[int, Any]:
    """Returns (step, state), every leaf a tensor on ``device``. With
    ``shardings`` (a matching tree of ``NamedSharding``s), each leaf is a
    DTensor placed by its sharding, onto whatever mesh the *current* job
    holds (elastic restart)."""
    if step is None:
        step = latest_step(ckpt_dir)
        assert step is not None, f"no checkpoints in {ckpt_dir}"
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for path, info in manifest["leaves"].items():
        file = os.path.join(d, path + ".npy")
        if shardings is None:
            flat[path] = torch.from_numpy(np.load(file)).to(device)
        else:
            sh = shardings
            for key in path.split("__"):
                sh = sh[key]
            flat[path] = _placed(file, info["shape"], sh, device)
    return step, _unflatten(flat)


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (one in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._sharded = False

    def save(self, step: int, state, meta=None):
        self.wait()
        # a host copy taken now: the optimizer overwrites the state's
        # tensors in place while the thread writes (a sharded state is
        # gathered here, by every rank, and written by rank 0)
        self._sharded = _sharded(state)
        host_state = tree_map(lambda x: _host(x, copy=True), state)
        if not _writer():
            return

        def _run():
            save(self.ckpt_dir, step, host_state, meta=meta, keep=self.keep)

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            import torch.distributed as dist
            dist.barrier()  # the files are complete for every rank
            self._sharded = False
