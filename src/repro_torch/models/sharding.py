"""Logical-axis sharding rules with divisibility fallbacks, as DTensor layouts.

The port of ``src/repro/models/sharding.py``. The production mesh is
fixed — ``(data=16, model=16)`` per pod, optionally a leading ``pod`` axis
— but head counts across the assigned architectures are not uniformly
divisible by 16 (llama4: 40H, smollm: 15H, musicgen: 24H). Model code
therefore annotates *logical* names and this module resolves them to mesh
axes per (config, shape, mesh), falling back when a dim does not divide:

  * q-heads not divisible by |model|  ->  attention shards the q-sequence
    ("attn_seq" -> model) instead of heads;
  * kv-heads not divisible            ->  decode caches shard the kv-sequence
    ("kv_seq" -> model);
  * batch=1 (long_500k)               ->  sequence takes the data axes.

Where the reference writes a ``PartitionSpec`` and lets XLA insert the
collectives, the port lays tensors out as ``torch.distributed.tensor``
DTensors on a ``DeviceMesh`` whose ``mesh_dim_names`` are the reference's
axis names: ``placements(spec, mesh)`` turns a spec into one placement per
mesh dim (an entry that names two axes, like ``("pod", "data")``, is
``Shard(i)`` on both mesh dims, major axis first, which is the chunk order
of JAX's row-major axis tuple), and ``shard(x, *names)`` redistributes a
DTensor to ``rules.spec(*names)``. The rule builders read only the mesh's
axis names and sizes, so they also take an ``AbstractMesh``
(``launch/mesh.py``), which the dry-run uses for meshes no job here has.

Rules live in a module-global context set by the step builders
(``repro_torch.launch.steps``); with no rules active ``shard`` is the
identity, so model code runs unmodified on one device.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig

Axes = Optional[Tuple[str, ...]]  # mesh axes for one logical name


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name, or
    a tuple of axis names (the dim split over their product, first axis
    major) — the reference's ``jax.sharding.PartitionSpec``, which also
    stores a one-axis tuple as that axis and an empty one as ``None``."""

    def __new__(cls, *parts):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else (e[0] if len(e) == 1 else tuple(e))
            return e
        return super().__new__(cls, tuple(norm(e) for e in parts))

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass
class Rules:
    """Resolved logical-name -> mesh-axes mapping for one (cfg, shape, mesh)."""

    mesh: object  # DeviceMesh or launch.mesh.AbstractMesh
    table: Dict[str, Axes]
    # resolved booleans model code may branch on
    shard_heads: bool = False
    shard_kv_heads: bool = False
    seq_shard_attn: bool = False

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return mesh_axis_sizes(self.mesh)

    def spec(self, *names: Optional[str]) -> PartitionSpec:
        parts = []
        for n in names:
            if n is None:
                parts.append(None)
            else:
                ax = self.table.get(n)
                if ax is None:
                    parts.append(None)
                elif len(ax) == 1:
                    parts.append(ax[0])
                else:
                    parts.append(ax)
        return P(*parts)


_ACTIVE: Optional[Rules] = None


def active_rules() -> Optional[Rules]:
    return _ACTIVE


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = rules
    try:
        yield
    finally:
        _ACTIVE = prev


def axis_size_of(name: str) -> int:
    """Product of mesh-axis sizes a logical name maps to (1 if inactive)."""
    r = _ACTIVE
    if r is None:
        return 1
    sizes = r.axis_sizes
    n = 1
    for a in r.table.get(name) or ():
        n *= sizes[a]
    return n


# ---------------------------------------------------------------------------
# specs as DTensor layouts
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on every
    mesh dim that tensor dim ``i`` names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = _entry_axes(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: axes {axes} of dim {i} are not in the "
                             f"mesh's order {tuple(names)}")
        for m in dims:
            if out[m] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[m]} shards two "
                                 "dims")
            out[m] = Shard(i)
    return out


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """Each rank's block of a ``shape`` tensor laid out by ``spec`` — the
    reference's ``NamedSharding(mesh, spec).shard_shape(shape)``."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        n = 1
        for a in _entry_axes(spec[i] if i < len(spec) else None):
            n *= sizes[a]
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {spec[i]} ({n})")
        out.append(dim // n)
    return tuple(out)


@dataclass
class NamedSharding:
    """A ``spec`` on a ``mesh`` (the reference's ``NamedSharding``): its
    DTensor ``placements`` and each rank's ``shard_shape``."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return shard_shape(shape, self.spec, self.mesh)


def to_layout(x, spec, mesh):
    """``x`` as a DTensor laid out by ``spec``: a DTensor is redistributed
    (a collective where the layout changes), a plain tensor, taken to be
    the same global value on every rank, is cut to this rank's block."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def shard(x, *names: Optional[str]):
    """Lay ``x`` out as the logical dims ``names`` say.

    Identity when no rules are active (one device) — model code is
    unconditional."""
    r = _ACTIVE
    if r is None:
        return x
    assert x.ndim == len(names), f"{tuple(x.shape)} vs {names}"
    return to_layout(x, r.spec(*names), r.mesh)


def local_pointwise(fn, x):
    """``fn``, an elementwise op, on ``x``: on a DTensor it runs on each
    rank's block (a partial sum is reduced first), for the ops DTensor has
    no sharding rule for (``log_sigmoid_backward``)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(x, DTensor):
        return fn(x)
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if list(x.placements) != pl:
        x = x.redistribute(x.device_mesh, pl)
    return local_map(fn, out_placements=pl, in_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


def whole_dim(x, dim: int = -1):
    """``x`` with dim ``dim`` on every rank whole (a DTensor sharded along
    it is gathered along it): for reductions over that dim, which DTensor
    would otherwise take as per-rank partial means."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    d = dim % x.ndim
    pl = [Replicate() if p.is_shard(d) else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh,
                                                             pl)


def whole_rows(x):
    """``x`` (B, ..., d) with every dim between the first and the last
    whole on every rank (a DTensor split along the sequence, as the
    ``act_seq`` stash is, is gathered along it): a product or a view that
    flattens the rows then sees its rows in order. The reference's XLA
    gathers a sequence-parallel stash before a column-parallel product the
    same way."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or x.ndim < 3:
        return x
    pl = [Replicate() if any(p.is_shard(d) for d in range(1, x.ndim - 1))
          else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh,
                                                             pl)


class _RowsWholeGrad(torch.autograd.Function):
    """The identity, whose backward pass gathers the gradient's rows
    (``whole_rows``): the gradient of a product's output reaches the
    product's backward with its rows in order, whatever layout the ops
    after it left on it."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return whole_rows(g)


def rows_whole_grad(y):
    """``y``; on a DTensor that needs a gradient, one whose gradient comes
    back with its rows whole (see ``_RowsWholeGrad``)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(y, DTensor) or not y.requires_grad:
        return y
    return _RowsWholeGrad.apply(y)


def split_dim(x, dim: int, n: int, size: int):
    """``x`` with dim ``dim`` (of n * size) viewed as (n, size). A DTensor
    split along that dim over more ranks than ``n`` divides is gathered
    along it first, since DTensor cannot view such a split as a split of
    the heads."""
    from torch.distributed.tensor import DTensor

    d = dim % x.ndim
    if isinstance(x, DTensor):
        ways = 1
        for m, p in enumerate(x.placements):
            if p.is_shard(d):
                ways *= x.device_mesh.size(m)
        if n % ways:
            x = whole_dim(x, d)
    return x.reshape(*x.shape[:d], n, size, *x.shape[d + 1:])


def split_last(x, n: int, size: int):
    """``x`` (..., n * size) as (..., n, size); see ``split_dim``."""
    return split_dim(x, -1, n, size)


def merge_last(x):
    """``x`` (..., n, size) as (..., n * size). On a DTensor the merge runs
    on each rank's block (``local_map``), the heads' split kept as the
    merged dim's, so the backward pass splits the gradient on blocks too
    (DTensor cannot view a gradient split along the merged dim over more
    ranks than ``n`` as a split of the heads)."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-2], -1)
    x = whole_dim(x, -1)
    nd = x.ndim
    pl = list(x.placements)
    out = [Shard(nd - 2) if p.is_shard(nd - 2) else p for p in pl]
    return local_map(lambda t: t.reshape(*t.shape[:-2], -1),
                     out_placements=out, in_placements=(pl,),
                     in_grad_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


def local_apply(fn, args, in_names, out_names):
    """``fn(*args)`` on each rank's blocks under active rules.

    Each arg is laid out by its logical dims (``in_names``, one tuple per
    arg; ``None`` for a non-tensor arg) and ``fn`` runs on the local
    blocks with no rules active, so it makes no collective; its outputs are
    taken as laid out by ``out_names``. For a computation that is
    independent along the sharded dims (attention per head or query
    chunk, the SSM scans per head, a recurrence per batch row). An input
    that is replicated over a mesh dim that an output is split over gets
    its gradient as a partial sum over that dim. Without rules, ``fn(*args)``.
    """
    r = _ACTIVE
    if r is None:
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = r.mesh
    in_pl = [None if n is None else placements(r.spec(*n), mesh)
             for n in in_names]
    out_pl = [placements(r.spec(*n), mesh) for n in out_names]
    split = [any(not pl[m].is_replicate() for pl in out_pl)
             for m in range(mesh.ndim)]
    grad_pl = [None if pl is None else
               [Partial() if split[m] and p.is_replicate() else p
                for m, p in enumerate(pl)] for pl in in_pl]
    laid = [a if pl is None else to_layout(a, r.spec(*n), mesh)
            for a, n, pl in zip(args, in_names, in_pl)]

    def body(*local):
        with use_rules(None):
            return fn(*local)

    return local_map(body, out_placements=tuple(out_pl) if len(out_pl) > 1
                     else out_pl[0], in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl),
                     device_mesh=mesh)(*laid)


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def make_rules(
    cfg: ModelConfig,
    mesh,
    *,
    kind: str,  # train | prefill | decode
    global_batch: int,
    seq_len: int,
) -> Rules:
    axis_sizes = mesh_axis_sizes(mesh)
    model_sz = axis_sizes.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    dp_sz = 1
    for a in dp_axes:
        dp_sz *= axis_sizes[a]

    shard_heads = _divides(cfg.num_heads, model_sz)
    shard_kv_heads = _divides(cfg.num_kv_heads, model_sz)
    seq_shard_attn = not shard_heads and _divides(seq_len, model_sz) and seq_len > 1

    # batch: prefer full DP; long_500k (batch=1) gives the data axes to seq.
    if _divides(global_batch, dp_sz):
        batch_ax: Axes = dp_axes
        long_mode = False
    else:
        batch_ax = None
        long_mode = True

    table: Dict[str, Axes] = {}
    table["batch"] = batch_ax
    table["vocab"] = ("model",)
    table["d_ff"] = ("model",)
    table["expert"] = ("model",)
    table["heads"] = ("model",) if shard_heads else None
    table["kv_heads"] = ("model",) if shard_kv_heads else None
    table["attn_seq"] = ("model",) if seq_shard_attn else None
    # SSM head count differs from attention head count (mamba2: d_in/64)
    if cfg.family == "hybrid":
        ssm_h = (cfg.ssm_expand * cfg.d_model) // 64
    elif cfg.family == "ssm":
        ssm_h = cfg.num_heads
    else:
        ssm_h = 0
    table["ssm_heads"] = ("model",) if _divides(ssm_h, model_sz) else None
    # inter-block activation stash: sequence-parallel over `model` for
    # attention families, embed-parallel for recurrent families (their scan
    # runs over sequence chunks and must see the full sequence locally).
    recurrent = cfg.family in ("ssm", "hybrid")
    if kind in ("train", "prefill") and seq_len > 1:
        if not recurrent and _divides(seq_len, model_sz):
            table["act_seq"] = ("model",)
            table["act_embed"] = None
        elif recurrent and _divides(cfg.d_model, model_sz):
            table["act_seq"] = None
            table["act_embed"] = ("model",)
        else:
            table["act_seq"] = None
            table["act_embed"] = None
    else:
        table["act_seq"] = None
        table["act_embed"] = None

    # decode KV cache: shard the time dim over `model`; in long mode
    # (batch=1) give it the data axes as well.
    kv_axes = []
    if long_mode:
        kv_axes.extend(dp_axes)
    kv_axes.append("model")
    total = 1
    for a in kv_axes:
        total *= axis_sizes[a]
    table["kv_seq"] = tuple(kv_axes) if _divides(seq_len, total) else None

    # embedding-dim of weights for FSDP: shard over data axes — training
    # only (serving re-pays the gather every step; weights are TP-sharded
    # and data-replicated there)
    table["fsdp"] = dp_axes if (dp_axes and kind == "train") else None
    table["seq_dp"] = dp_axes if long_mode and _divides(seq_len, dp_sz) else None

    return Rules(
        mesh=mesh,
        table=table,
        shard_heads=shard_heads,
        shard_kv_heads=shard_kv_heads,
        seq_shard_attn=seq_shard_attn,
    )


# ---------------------------------------------------------------------------
# Parameter shardings (FSDP over data axes + TP over model)
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig, params, mesh, *, fsdp_params: bool = True
                ) -> Dict:
    """PartitionSpec tree matching ``params`` (any leaves with ``.shape``).

    Convention by path name (see models/*.py param layouts):
      * ...embedding "table" (V, d)            -> (model, fsdp)
      * attention wq/wo etc. (d, n)            -> (fsdp, model)
      * moe experts w* (E, d, f)               -> (model, fsdp, None)
      * norm scales / biases / small vectors   -> replicated
    Stacked-layer params have a leading L dim (replicated).

    ``fsdp_params=False`` drops the data-axis shard (TP-only): the serving
    layout — decode would otherwise re-pay the full FSDP all-gather on
    every token step.
    """
    axis_sizes = mesh_axis_sizes(mesh)
    model_sz = axis_sizes.get("model", 1)
    dp_axes = tuple(a for a in ("pod", "data") if a in axis_sizes)
    dp_sz = 1
    for a in dp_axes:
        dp_sz *= axis_sizes[a]
    if not fsdp_params:
        dp_axes = ()
        dp_sz = 1
    fsdp = dp_axes if dp_axes else None

    def spec_for(path: str, x) -> PartitionSpec:
        shape = tuple(x.shape)
        name = path.split("/")[-1]
        nstack = 1 if "stacked" in path else 0  # leading layer dim(s)
        # normalize: dims after the stack prefix
        dims = shape[nstack:] if nstack else shape
        pad = (None,) * nstack

        def ok(dim_idx, sz):
            return dims[dim_idx] % sz == 0

        if name in ("scale", "bias", "a_log", "dt_bias", "d_skip") or len(dims) <= 1:
            return P(*pad, *([None] * len(dims)))
        if name == "table":  # (V, d) embedding / unembedding
            v_ok = ok(0, model_sz)
            d_ok = ok(1, dp_sz) if fsdp else False
            return P(*pad, "model" if v_ok else None, fsdp if d_ok else None)
        if name == "expert_w2":  # (E, f, d): FSDP on the *output* dim
            e_ok = ok(0, model_sz)
            d_ok = ok(2, dp_sz) if fsdp else False
            return P(*pad, "model" if e_ok else None, None, fsdp if d_ok else None)
        if name.startswith("expert"):  # (E, d, f)
            e_ok = ok(0, model_sz)
            d_ok = ok(1, dp_sz) if fsdp else False
            return P(
                *pad,
                "model" if e_ok else None,
                fsdp if d_ok else None,
                *([None] * (len(dims) - 2)),
            )
        if len(dims) == 2:  # (in, out) dense kernels
            in_ok = ok(0, dp_sz) if fsdp else False
            out_ok = ok(1, model_sz)
            # FSDP on the input dim, TP on the output dim when divisible;
            # fall back to sharding whichever side divides.
            if out_ok:
                return P(*pad, fsdp if in_ok else None, "model")
            if in_ok:
                return P(*pad, fsdp, None)
            return P(*pad, None, None)
        return P(*pad, *([None] * len(dims)))

    def build(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: build(v, prefix + "/" + str(k)) for k, v in tree.items()}
        return spec_for(prefix, tree)

    return build(params)


def named_sharding_tree(cfg: ModelConfig, params, mesh, *,
                        fsdp_params: bool = True):
    """The ``NamedSharding`` tree of ``params`` on ``mesh`` (each leaf's
    DTensor placements are its ``.placements``)."""
    specs = param_specs(cfg, params, mesh, fsdp_params=fsdp_params)

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        return NamedSharding(mesh, t)

    return rec(specs)
