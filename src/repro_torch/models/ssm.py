"""State-space / recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM + sLSTM).

The port of ``src/repro/models/ssm.py``. Both Mamba2 and mLSTM are
instances of one gated linear RNN

    S_t = exp(logdecay_t) * S_{t-1} + B_t ⊗ X_t          S: (H, N, P)
    Y_t = C_t · S_t                                       Y: (H, P)

computed chunkwise (``chunked_linear_rnn``): intra-chunk contributions as
quadratic-in-chunk einsums, the inter-chunk state carried by a Python loop
over chunks (the reference's ``lax.scan``) — the SSD decomposition
[arXiv:2405.21060].

sLSTM has a true nonlinear recurrence (the hidden state feeds the gates),
so it runs as a Python loop over time (the reference's ``lax.scan``) with
block-diagonal recurrent weights and the exponential-gating stabiliser
[arXiv:2405.04517]. Recurrent states are f32, as ``init_caches`` gives
them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import (
    _ones,
    _zeros,
    apply_norm,
    dense_init,
    f32_einsum,
    linear,
    norm_init,
    normal,
)
from repro_torch.models.sharding import (local_apply, local_pointwise,
                                         merge_last, shard, split_last,
                                         whole_dim, whole_rows)

f32 = torch.float32

# ---------------------------------------------------------------------------
# shared chunked linear RNN (SSD form)
# ---------------------------------------------------------------------------


def _segsum(x):
    """log-space segment sums: x (..., L) -> (..., L, L) lower-triangular
    cumulative sums  out[..., i, j] = sum_{k=j+1..i} x[..., k]  (i >= j)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(L, device=x.device)
    mask = i[:, None] >= i[None, :]
    return out.masked_fill(~mask, -math.inf)


def chunked_linear_rnn(
    C: torch.Tensor,  # (B, L, H, N)   "query"/output mixer
    Bm: torch.Tensor,  # (B, L, H, N)  "key"/input mixer
    X: torch.Tensor,  # (B, L, H, P)   values
    logdecay: torch.Tensor,  # (B, L, H) per-step log decay (<= 0)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, N, P)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (Y (B,L,H,P), final_state (B,H,N,P)).

    Under sharding rules each rank runs the scan on its block (batch rows
    and ``ssm_heads``), whole along the sequence (``local_apply``)."""
    seq = ("batch", None, "ssm_heads", None)
    state = ("batch", "ssm_heads", None, None)
    return local_apply(
        lambda *a: _chunked_linear_rnn(*a, chunk=chunk),
        (C, Bm, X, logdecay, initial_state),
        (seq, seq, seq, ("batch", None, "ssm_heads"),
         None if initial_state is None else state), (seq, state))


def _chunked_linear_rnn(C, Bm, X, logdecay, initial_state, *, chunk):
    B, L, H, N = C.shape
    P = X.shape[-1]
    cl = min(chunk, L)
    nc = L // cl
    assert L % cl == 0, (L, cl)

    Cc = shard(C.reshape(B, nc, cl, H, N), "batch", None, None, "ssm_heads", None)
    Bc = shard(Bm.reshape(B, nc, cl, H, N), "batch", None, None, "ssm_heads", None)
    Xc = shard(X.reshape(B, nc, cl, H, P), "batch", None, None, "ssm_heads", None)
    ld = logdecay.reshape(B, nc, cl, H).float()

    # intra-chunk: scores[b,c,h,i,j] = C_i · B_j * exp(sum_{j<k<=i} ld_k)
    seg = _segsum(ld.movedim(-1, -2))  # (B, nc, H, cl, cl)
    scores = f32_einsum("bcihn,bcjhn->bchij", Cc, Bc)
    scores = shard(scores, "batch", None, "ssm_heads", None, None)
    scores = scores * torch.exp(seg)
    y_intra = f32_einsum("bchij,bcjhp->bcihp", scores.to(X.dtype), Xc)

    # per-chunk end states: state_c = sum_j exp(sum_{k>j} ld) B_j X_j
    total = ld.sum(2)  # (B, nc, H)
    decay_tail = torch.exp(total[:, :, None, :] - torch.cumsum(ld, 2))
    chunk_states = f32_einsum("bcjhn,bcjh,bcjhp->bchnp", Bc, decay_tail, Xc)

    # inter-chunk walk over chunk states
    s = (initial_state.float() if initial_state is not None
         else torch.zeros((B, H, N, P), dtype=f32, device=C.device))
    entering = []
    for c in range(nc):
        entering.append(s)  # state entering chunk c
        s = s * torch.exp(total[:, c])[:, :, None, None] + chunk_states[:, c]
    entering = torch.stack(entering, dim=1)  # (B, nc, H, N, P)

    # contribution of the entering state within each chunk
    decay_in = torch.exp(torch.cumsum(ld, 2))  # (B, nc, cl, H)
    y_inter = f32_einsum("bcihn,bcih,bchnp->bcihp", Cc, decay_in, entering)
    y = (y_intra + y_inter).reshape(B, L, H, P)
    return y.to(X.dtype), s


def linear_rnn_step(
    C, Bm, X, logdecay, state
):  # shapes: (B,H,N), (B,H,N), (B,H,P), (B,H), (B,H,N,P)
    """Single decode step of the same recurrence (under sharding rules on
    each rank's batch rows and heads, ``local_apply``)."""
    bh = ("batch", "ssm_heads", None)
    st = ("batch", "ssm_heads", None, None)
    return local_apply(_rnn_step, (C, Bm, X, logdecay, state),
                       (bh, bh, bh, ("batch", "ssm_heads"), st), (bh, st))


def _rnn_step(C, Bm, X, logdecay, state):
    s = state.float() * torch.exp(logdecay.float())[..., None, None]
    s = s + Bm.float()[..., None] * X.float()[..., None, :]
    y = f32_einsum("bhn,bhnp->bhp", C, s)
    return y.to(X.dtype), s


# ---------------------------------------------------------------------------
# Mamba2 block  [arXiv:2405.21060]
# ---------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    head_p = 64
    H = d_in // head_p
    return d_in, H, head_p, cfg.ssm_state


def init_mamba2(gen, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    d = cfg.d_model
    d_in, H, P, N = mamba2_dims(cfg)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                     device=gen.device))  # A = -exp(a_log)
    return {
        "wx": dense_init(gen, d, d_in, lead=lead),
        "wz": dense_init(gen, d, d_in, lead=lead),
        "wB": dense_init(gen, d, N, lead=lead),
        "wC": dense_init(gen, d, N, lead=lead),
        "wdt": dense_init(gen, d, H, lead=lead),
        "dt_bias": _zeros(gen, *lead, H),
        "a_log": a_log.expand(*lead, H).clone(),
        "d_skip": _ones(gen, *lead, H),
        "conv": {"w": normal(gen, (*lead, cfg.ssm_conv, d_in + 2 * N),
                             1.0 / math.sqrt(cfg.ssm_conv))},
        "wo": dense_init(gen, d_in, d, lead=lead),
        "gn": {"scale": _ones(gen, *lead, d_in)},
    }


def _causal_conv(xbc, w, state=None):
    """xbc: (B, L, Cch); w: (W, Cch) depthwise causal conv.

    Returns (y, new_state) where state is the trailing (W-1) inputs.
    """
    B, L, Cch = xbc.shape
    W = w.shape[0]
    if state is None:
        state = torch.zeros((B, W - 1, Cch), dtype=xbc.dtype,
                            device=xbc.device)
    xp = torch.cat([state.to(xbc.dtype), xbc], dim=1)  # (B, L+W-1, C)
    out = torch.zeros((B, L, Cch), dtype=f32, device=xbc.device)
    for i in range(W):
        out = out + xp[:, i: i + L, :].float() * w[i].float()
    new_state = xp[:, L:, :] if W > 1 else state
    return out.to(xbc.dtype), new_state


def _gated_rms(y, scale, dtype):
    yf = whole_dim(y).float()
    y = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-6)
    return (y * scale).to(dtype)


def mamba2(cfg: ModelConfig, p, x, *, cache=None, mode="train"):
    """x: (B, L, d). cache: {"ssm": (B,H,N,P), "conv": (B,W-1,C)}."""
    B, L, d = x.shape
    d_in, H, P, N = mamba2_dims(cfg)
    dt_ = x.dtype

    x = whole_rows(x)  # gathered once for the five input products
    xin = linear(p["wx"], x, dt_)  # (B,L,d_in)
    z = linear(p["wz"], x, dt_)
    Bv = linear(p["wB"], x, dt_)  # (B,L,N)
    Cv = linear(p["wC"], x, dt_)
    dt_pre = linear(p["wdt"], x, f32) + p["dt_bias"]  # (B,L,H)

    xbc = torch.cat([xin, Bv, Cv], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv"]["w"], conv_state)
    xbc = F.silu(xbc)
    xin, Bv, Cv = torch.split(xbc, [d_in, N, N], dim=-1)

    dt = F.softplus(dt_pre)  # (B,L,H)
    A = -torch.exp(p["a_log"])  # (H,)
    logdecay = dt * A[None, None, :]  # (B,L,H)

    xh = shard(split_last(xin, H, P), "batch", None, "ssm_heads", None)
    Bh = Bv[:, :, None, :].expand(B, L, H, N)
    Ch = Cv[:, :, None, :].expand(B, L, H, N)
    xs = xh * dt[..., None].to(dt_)

    ssm_state = cache["ssm"] if cache is not None else None
    if mode == "decode":
        assert L == 1
        y, new_state = linear_rnn_step(
            Ch[:, 0], Bh[:, 0], xs[:, 0], logdecay[:, 0], ssm_state)
        y = y[:, None]
    else:
        y, new_state = chunked_linear_rnn(
            Ch, Bh, xs, logdecay, cfg.ssm_chunk, initial_state=ssm_state)

    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = merge_last(y).to(dt_)
    # gated RMSNorm (Mamba2 uses RMSNorm(y * silu(z)))
    y = _gated_rms(y * F.silu(z), p["gn"]["scale"], dt_)
    out = linear(p["wo"], y, dt_)

    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"ssm": new_state, "conv": new_conv}
    return out, new_cache


# ---------------------------------------------------------------------------
# xLSTM: mLSTM block  [arXiv:2405.04517]
# ---------------------------------------------------------------------------


def mlstm_dims(cfg: ModelConfig):
    d_in = 2 * cfg.d_model  # proj factor 2
    H = cfg.num_heads
    P = d_in // H
    return d_in, H, P


def init_mlstm(gen, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    d = cfg.d_model
    d_in, H, P = mlstm_dims(cfg)
    return {
        "wup": dense_init(gen, d, d_in, lead=lead),
        "wz": dense_init(gen, d, d_in, lead=lead),
        "wq": dense_init(gen, d_in, d_in, lead=lead),
        "wk": dense_init(gen, d_in, d_in, lead=lead),
        "wv": dense_init(gen, d_in, d_in, lead=lead),
        "wi": dense_init(gen, d_in, H, lead=lead),
        "wf": dense_init(gen, d_in, H, lead=lead),
        "conv": {"w": normal(gen, (*lead, 4, d_in), 0.5)},
        "wo": dense_init(gen, d_in, d, lead=lead),
        "gn": {"scale": _ones(gen, *lead, d_in)},
    }


def mlstm(cfg: ModelConfig, p, x, *, cache=None, mode="train"):
    """mLSTM with matrix memory, run through the shared chunked linear RNN.

    Stabilisation: sigmoid forget gate (log-space decay), exp input gate
    clamped at 0 — the recurrent decode step matches this parallel form.
    """
    B, L, d = x.shape
    d_in, H, P = mlstm_dims(cfg)
    dt_ = x.dtype

    x = whole_rows(x)  # gathered once for both input products
    up = linear(p["wup"], x, dt_)
    z = linear(p["wz"], x, dt_)
    conv_state = cache["conv"] if cache is not None else None
    c, new_conv = _causal_conv(up, p["conv"]["w"], conv_state)
    c = F.silu(c)

    q = split_last(linear(p["wq"], c, dt_), H, P) / math.sqrt(P)
    k = split_last(linear(p["wk"], c, dt_), H, P) / math.sqrt(P)
    v = split_last(linear(p["wv"], up, dt_), H, P)

    logf = local_pointwise(F.logsigmoid, linear(p["wf"], c, f32))  # (B,L,H)
    logi = torch.clamp_max(linear(p["wi"], c, f32), 0.0)
    i_gate = torch.exp(logi)

    kx = k * i_gate[..., None].to(dt_)
    ssm_state = cache["ssm"] if cache is not None else None
    norm_state = cache["norm"] if cache is not None else None
    if mode == "decode":
        assert L == 1
        h, new_state = linear_rnn_step(q[:, 0], kx[:, 0], v[:, 0], logf[:, 0],
                                       ssm_state)
        ones = torch.ones((B, H, 1), dtype=dt_, device=x.device)
        nrm, new_norm = linear_rnn_step(q[:, 0], kx[:, 0], ones, logf[:, 0],
                                        norm_state)
        h, nrm = h[:, None], nrm[:, None]
    else:
        h, new_state = chunked_linear_rnn(
            q, kx, v, logf, cfg.ssm_chunk, initial_state=ssm_state)
        ones = torch.ones((B, L, H, 1), dtype=dt_, device=x.device)
        nrm, new_norm = chunked_linear_rnn(
            q, kx, ones, logf, cfg.ssm_chunk, initial_state=norm_state)
    h = h / torch.clamp_min(nrm.abs(), 1.0).to(h.dtype)

    h = _gated_rms(merge_last(h), p["gn"]["scale"], dt_)
    out = linear(p["wo"], h * F.silu(z), dt_)

    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"ssm": new_state, "norm": new_norm, "conv": new_conv}
    return out, new_cache


# ---------------------------------------------------------------------------
# xLSTM: sLSTM block (true nonlinear recurrence -> a loop over time)
# ---------------------------------------------------------------------------


def slstm_dims(cfg: ModelConfig):
    H = cfg.num_heads
    P = cfg.d_model // H
    return H, P


def init_slstm(gen, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    d = cfg.d_model
    H, P = slstm_dims(cfg)
    # input projections for the 4 gates + block-diag recurrent weights
    return {
        "wgates": dense_init(gen, d, 4 * d, lead=lead),
        "r": normal(gen, (*lead, 4, H, P, P), 1.0 / math.sqrt(P)),
        "bias": _zeros(gen, *lead, 4, d),
        "ln": norm_init(gen, cfg, d, lead),
        "wup": dense_init(gen, d, 2 * (4 * d // 3), lead=lead),
        "wdown": dense_init(gen, 4 * d // 3, d, lead=lead),
    }


def _slstm_scan(gates_in, r, c, n, h, m, H: int, P: int):
    """The sLSTM time loop on plain tensors: gates_in (B, L, 4, d), block
    recurrent weights r (4, H, P, P), states (B, d) -> (h over time
    (B, L, d) f32, c, n, h, m)."""
    B, L, _, d = gates_in.shape
    r = r.float()
    hs = []
    for t in range(L):
        rec = torch.einsum("ghpq,bhq->bghp", r, h.reshape(B, H, P)
                           ).reshape(B, 4, d)
        pre = gates_in[:, t] + rec
        zi = torch.tanh(pre[:, 0])
        i_pre = pre[:, 1]  # per-cell exponential gates (B, d)
        logf = F.logsigmoid(pre[:, 2])
        o = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(logf + m, i_pre)  # stabiliser state
        i_g = torch.exp(i_pre - m_new)
        f_g = torch.exp(logf + m - m_new)
        c = f_g * c + i_g * zi
        n = f_g * n + i_g
        h = o * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), c, n, h, m


def slstm(cfg: ModelConfig, p, x, *, cache=None, mode="train"):
    """x: (B, L, d). Exponential gating with stabiliser state m (faithful).

    cache: {"c","n","h","m": (B,d)}
    """
    B, L, d = x.shape
    H, P = slstm_dims(cfg)

    gates_in = linear(p["wgates"], x, f32).reshape(B, L, 4, d) + p["bias"]

    if cache is not None:
        c, n, h, m = cache["c"], cache["n"], cache["h"], cache["m"]
    else:
        c = torch.zeros((B, d), dtype=f32, device=x.device)
        n = torch.full((B, d), 1e-6, dtype=f32, device=x.device)
        h = torch.zeros((B, d), dtype=f32, device=x.device)
        m = torch.zeros((B, d), dtype=f32, device=x.device)

    # the recurrence runs per batch row: under sharding rules, on each
    # rank's rows (``local_apply``)
    row = ("batch", None)
    y, c, n, h, m = local_apply(
        lambda g, r, c, n, h, m: _slstm_scan(g, r, c, n, h, m, H, P),
        (gates_in, p["r"], c, n, h, m),
        (("batch", None, None, None), (None,) * 4, row, row, row, row),
        (("batch", None, None), row, row, row, row))
    y = y.to(x.dtype)  # (B, L, d)

    # post-up/down projection (GLU, proj factor 4/3)
    y = apply_norm(cfg, p["ln"], y)
    u1, u2 = linear(p["wup"], y, x.dtype).chunk(2, dim=-1)
    out = linear(p["wdown"], F.gelu(u1, approximate="tanh") * u2, x.dtype)

    new_cache = None
    if mode in ("prefill", "decode"):
        new_cache = {"c": c, "n": n, "h": h, "m": m}
    return out, new_cache
