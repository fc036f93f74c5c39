"""Mesh construction over ``torch.distributed``.

The port of ``src/repro/launch/mesh.py``. Single pod: (data=16,
model=16) = 256 ranks. Multi-pod: (pod=2, data=16, model=16) = 512 ranks;
the ``pod`` axis carries only data-parallel all-reduces. Each builder
returns a ``DeviceMesh`` over the running process group, with the
reference's axis names as its ``mesh_dim_names``; ``abstract=True``
returns an ``AbstractMesh`` instead (axis names and sizes, no process
group), which is all the rule builders and the dry-run read.

The process group is the caller's to start (``init_ranks``), with an
explicit backend:

  * ``"nccl"`` — one card per rank;
  * ``"gloo"`` — any device; gloo runs its collectives on host memory and
    takes CUDA tensors only for some of them;
  * ``"gloo-staged"`` — gloo with the collectives it cannot run on CUDA
    tensors staged through pinned host buffers in code of this module
    (``_register_staged``, ``p2p_exchange``), so several ranks can share
    one card (NCCL refuses two ranks on one GPU). It is chosen by name,
    never switched to behind the caller's back.

Each rank's device is explicit: ``cuda:{local_rank % device_count}`` unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Tuple

import torch

#: the collectives ``gloo-staged`` runs through host memory for CUDA
#: tensors, the ones gloo crashes on with device pointers
#: (``scripts/gloo_cuda_probe.py``; PERF.md §6); gloo runs the others
#: (all-reduce, reduce-scatter, all-to-all, broadcast) on CUDA tensors
STAGED = ("all_gather_into_tensor (DTensor's functional all-gather)",
          "send/recv (batch_isend_irecv)")


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without a process group (``DeviceMesh``'s
    ``mesh_dim_names`` / ``shape``)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def _axes(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def rank_device(device: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for
    ``"cuda"``, else ``device`` as given."""
    if device != "cuda":
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_ranks(backend: str, *, device: str = "cuda",
               timeout_s: float = 600.0) -> torch.device:
    """Join the process group that ``torch.distributed.run`` (or the
    ``MASTER_ADDR``/``RANK``/``WORLD_SIZE`` environment) describes, over
    ``backend`` (``nccl``, ``gloo`` or ``gloo-staged``), and return this
    rank's device. A no-op join when the group is already up."""
    import torch.distributed as dist

    global _BACKEND
    if backend not in ("nccl", "gloo", "gloo-staged"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if backend == "gloo-staged":
            _register_staged()
        dist.init_process_group(
            backend="gloo" if backend == "gloo-staged" else backend,
            timeout=timedelta(seconds=timeout_s))
        _BACKEND = backend
    return dev


def make_mesh(shape, axes, *, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the running group
    (ranks in row-major order)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}, have "
                           f"{dist.get_world_size()}")
    dev = rank_device(device)
    ids = torch.arange(n).reshape(tuple(shape))
    return DeviceMesh(dev.type, ids, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, abstract: bool = False,
                         device: str = "cuda"):
    shape, axes = _axes(multi_pod)
    if abstract:
        return AbstractMesh(shape, axes)
    return make_mesh(shape, axes, device=device)


def make_host_mesh(*, device: str = "cuda"):
    """Whatever mesh the running group supports (elastic restart helper):
    prefers (data=N/16, model=16), falls back to (data=N, model=1)."""
    import torch.distributed as dist

    n = dist.get_world_size()
    shape = (n // 16, 16) if n % 16 == 0 and n >= 16 else (n, 1)
    return make_mesh(shape, ("data", "model"), device=device)


# ---------------------------------------------------------------------------
# gloo with host staging
# ---------------------------------------------------------------------------

_BACKEND: Optional[str] = None  # the name init_ranks was given
_STAGED_LIB = None  # keeps the staged kernels registered


def backend_name() -> Optional[str]:
    """The backend ``init_ranks`` started (``gloo-staged`` included)."""
    return _BACKEND


def staged() -> bool:
    """Whether this process runs the ``gloo-staged`` backend."""
    return _BACKEND == "gloo-staged"


def _pinned_like(t: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.empty(t.shape if shape is None else shape, dtype=t.dtype,
                       pin_memory=torch.cuda.is_available())


def _staged_all_gather(input, group_size, group_name):
    """``_c10d_functional.all_gather_into_tensor`` through host memory:
    the input's copy in a pinned buffer, gloo's all-gather there, the
    result copied back to the input's device."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    pg = _resolve_process_group(group_name)
    h_in = _pinned_like(input)
    h_in.copy_(input)
    h_out = _pinned_like(input, (group_size * input.shape[0],
                                 *input.shape[1:]))
    dist.all_gather_into_tensor(h_out, h_in, group=pg)
    return h_out.to(input.device)


def _register_staged(key: str = "CUDA"):
    """Route the collectives gloo cannot run on ``key`` tensors through
    host memory: DTensor's all-gather (``_c10d_functional``'s
    ``all_gather_into_tensor``, which gloo crashes on with CUDA tensors)
    gets a kernel of its own for that dispatch key. Point-to-point sends
    (gloo aborts on those too) are staged where the port makes them
    (``p2p_exchange``)."""
    global _STAGED_LIB
    if _STAGED_LIB is None:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", _staged_all_gather, key)
        _STAGED_LIB = lib


def p2p_exchange(send: torch.Tensor, dst: int, recv: torch.Tensor, src: int,
                 group=None):
    """Send ``send`` to group rank ``dst`` while receiving ``recv`` from
    group rank ``src`` (``batch_isend_irecv``); through pinned host
    buffers under ``gloo-staged``. Plain gloo aborts the process on a CUDA
    tensor here, so it is refused instead."""
    import torch.distributed as dist

    g_dst = dist.get_global_rank(group, dst) if group is not None else dst
    g_src = dist.get_global_rank(group, src) if group is not None else src
    on_card = send.device.type == "cuda"
    if on_card and _BACKEND == "gloo":
        raise RuntimeError("gloo sends no CUDA tensor point to point; start "
                           "the ranks with backend 'gloo-staged'")
    if on_card and staged():
        h_send, h_recv = _pinned_like(send), _pinned_like(recv)
        h_send.copy_(send)
    else:
        h_send, h_recv = send, recv
    ops = [dist.P2POp(dist.isend, h_send, g_dst, group),
           dist.P2POp(dist.irecv, h_recv, g_src, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if h_recv is not recv:
        recv.copy_(h_recv)
    return recv
