"""Gradient compression: int8 ring reduce-scatter/all-gather with error
feedback.

The port of ``src/repro/train/compression.py``: ``_quant`` / ``_dequant``
(one f32 scale per tensor, values rounded half to even into [-127, 127],
as ``jnp.round`` and ``torch.round`` both round), ``ErrorFeedback``,
which carries each leaf's quantisation error into the next step, and the
int8 ring all-reduce. The ring is explicit point-to-point traffic over
the axis's process group (``batch_isend_irecv``, ``i -> (i+1) % n``,
through ``launch.mesh.p2p_exchange``), so the wire format is truly int8
plus one f32 scale per chunk, a 4x wire reduction against f32; its
quantisation and add order are the reference's, so on the same inputs it
is bit-equal to the JAX ring.

``compressed_psum(x, axis, mesh)`` is a drop-in for a sum over the named
mesh axis; ``ErrorFeedback`` holds per-leaf residuals.
"""

from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_map


def _quant(x):
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.float() * scale


def _ring_allreduce_int8(x, group=None):
    """Reduce-scatter + all-gather rings with an int8 payload: the sum of
    every rank's ``x`` over ``group``, on every rank of it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import p2p_exchange

    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    nxt, prv = (idx + 1) % n, (idx - 1) % n

    def ring(payload, scale):
        got_p = p2p_exchange(payload, nxt, torch.empty_like(payload), prv,
                             group)
        got_s = p2p_exchange(scale.reshape(1), nxt,
                             torch.empty(1, dtype=scale.dtype,
                                         device=scale.device), prv, group)
        return got_p, got_s[0]

    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    flat = torch.cat([flat, torch.zeros((pad,), dtype=flat.dtype,
                                        device=flat.device)])
    acc = flat.reshape(n, -1).clone()

    # reduce-scatter ring: after n-1 steps, rank r holds the full sum of
    # chunk (r+1) mod n
    for s in range(n - 1):
        send_idx = (idx - s) % n
        payload, scale = ring(*_quant(acc[send_idx]))
        recv_idx = (idx - s - 1) % n
        acc[recv_idx] = acc[recv_idx] + _dequant(payload, scale)
    mine = (idx + 1) % n
    my_chunk, my_scale = _quant(acc[mine])

    # all-gather ring of the reduced chunks
    out = torch.zeros_like(acc)
    out[mine] = _dequant(my_chunk, my_scale)
    payload, scale, src = my_chunk, my_scale, mine
    for s in range(n - 1):
        payload, scale = ring(payload, scale)
        src = (src - 1) % n
        out[src] = _dequant(payload, scale)
    res = out.reshape(-1)
    if pad:
        res = res[:-pad]
    return res.reshape(x.shape)


def compressed_psum(x, axis_name: str, mesh):
    """int8 ring all-reduce over mesh axis ``axis_name``: of a DTensor
    replicated over the mesh (each rank's copy enters the ring, as the
    reference's ``shard_map`` with replicated specs), or of a plain tensor
    holding this rank's own value; the result in the same form."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    group = mesh.get_group(axis_name)
    if not isinstance(x, DTensor):
        return _ring_allreduce_int8(x, group)
    rep = [Replicate()] * mesh.ndim
    return local_map(lambda t: _ring_allreduce_int8(t, group),
                     out_placements=rep, in_placements=(rep,),
                     device_mesh=mesh)(x.redistribute(mesh, rep))


class ErrorFeedback:
    """Per-leaf residual accumulator: g' = Q(g + e); e = (g + e) − g'."""

    def __init__(self, params_like):
        self.residual = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params_like)

    def apply(self, grads, reduce_fn):
        reduced, residual = {}, {}

        def one(g, e):
            x = g.float() + e
            q, scale = _quant(x)
            sent = _dequant(q, scale)
            return reduce_fn(sent), x - sent

        def rec(g, e, red, res):
            for k in g:
                if isinstance(g[k], dict):
                    red[k], res[k] = {}, {}
                    rec(g[k], e[k], red[k], res[k])
                else:
                    red[k], res[k] = one(g[k], e[k])

        rec(grads, self.residual, reduced, residual)
        self.residual = residual
        return reduced
