"""Private transformer inference on top of the PiT protocol.

BERT-style post-norm encoder stack (the paper's evaluation model), with
every layer routed per the APINT recipe:

  linear layers     -> DELPHI split (HE offline, standard matmul online)
  QKᵀ / PV          -> Beaver matmul (private × private)
  softmax / GeLU    -> GC (share-reconstruct → i-BERT/LUT circuit → remask)
  truncation        -> tiny GC (exact deferred rescale — keeps all scales
                       at `frac` across residuals)
  LayerNorm         -> full-GC baseline or the APINT Fig. 4 offload

The port serves through ``compile_session`` → ``preprocess`` → ``run``
(:mod:`repro_torch.core.session`), whose plan is traced from the model's
shapes exactly as the JAX package traces its eager ``forward_private``;
``forward_private`` itself is kept as the eager compatibility path, on
the protocol's single-call wrappers. ``forward_float`` is the float
reference for the accuracy check.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import List, Sequence

import numpy as np

from repro_torch.config import PrivacyConfig
from repro_torch.core import secret_sharing as SS
from repro_torch.core.protocol import PiTProtocol


@dataclass
class BertWeights:
    """Per-layer float weights (numpy)."""

    wq: np.ndarray
    wk: np.ndarray
    wv: np.ndarray
    wo: np.ndarray
    w1: np.ndarray
    w2: np.ndarray
    ln1_g: np.ndarray
    ln1_b: np.ndarray
    ln2_g: np.ndarray
    ln2_b: np.ndarray


def random_weights(rng, d: int, d_ff: int, layers: int) -> List[BertWeights]:
    """Seeded random weights, drawn in the JAX package's order (so one
    numpy generator yields the same model in both packages)."""
    def w(shape, scale):
        return rng.normal(0, scale, shape)

    out = []
    s = 1.0 / math.sqrt(d)
    for _ in range(layers):
        out.append(
            BertWeights(
                wq=w((d, d), s), wk=w((d, d), s), wv=w((d, d), s),
                wo=w((d, d), s),
                w1=w((d_ff, d), s), w2=w((d, d_ff), 1.0 / math.sqrt(d_ff)),
                ln1_g=rng.normal(1, 0.05, d), ln1_b=rng.normal(0, 0.05, d),
                ln2_g=rng.normal(1, 0.05, d), ln2_b=rng.normal(0, 0.05, d),
            )
        )
    return out


def weights_from_reference(ws: Sequence) -> List[BertWeights]:
    """The JAX package's ``BertWeights`` (or any objects with the same
    numpy attributes) as the port's weights, copied as float64 arrays."""
    return [BertWeights(**{f.name: np.array(getattr(w, f.name), np.float64)
                           for f in fields(BertWeights)}) for w in ws]


class PrivateTransformer:
    def __init__(self, pcfg: PrivacyConfig, d: int, heads: int, d_ff: int,
                 weights: List[BertWeights], *, seed: int = 0,
                 activation: str = "gelu", device="cuda"):
        assert d % heads == 0
        self.device = device
        self.p = PiTProtocol(pcfg, seed=seed, device=device)
        self.d, self.h, self.hd, self.d_ff = d, heads, d // heads, d_ff
        self.weights = weights
        self.activation = activation
        self.scale_q = 1.0 / math.sqrt(self.hd)

    # ------------------------------------------------------------------
    def compile_session(self, seq_len: int, *, seed: int = 0,
                        device=None, wire_version: int = 1,
                        compression: bool = True):
        """Offline/online serving API: trace this model into a
        ``PiTSession`` (see ``repro_torch.core.session``) for one request
        bucket, garbling and evaluating on ``device`` (default: the
        model's).

        ``session.preprocess(n)`` then runs all garbling/HE/triple work up
        front; each ``session.run(x, bundle)`` is online-phase only.
        ``wire_version`` selects which wire revision the session's
        channel meter models.
        """
        from repro_torch.core import session as PS

        return PS.compile(self, shape=(seq_len, self.d), seed=seed,
                          device=device, wire_version=wire_version,
                          compression=compression)

    # ------------------------------------------------------------------
    def forward_float(self, x: np.ndarray) -> np.ndarray:
        from repro_torch.core.circuits.nonlinear import _gelu

        def act(v):
            if self.activation == "gelu":
                return np.vectorize(lambda z: _gelu(max(min(z, 4), -4)))(v)
            vv = np.clip(v, -6, 6)
            return vv / (1 + np.exp(-vv))

        def ln(v, g, b):
            mu = v.mean(-1, keepdims=True)
            sd = np.sqrt(((v - mu) ** 2).mean(-1, keepdims=True) + 1e-9)
            return (v - mu) / sd * g + b

        for W in self.weights:
            q = x @ (W.wq * self.scale_q).T
            k = x @ W.wk.T
            v = x @ W.wv.T
            ctx = np.zeros_like(x)
            for h in range(self.h):
                sl = slice(h * self.hd, (h + 1) * self.hd)
                s = q[:, sl] @ k[:, sl].T
                e = np.exp(s - s.max(-1, keepdims=True))
                pmat = e / e.sum(-1, keepdims=True)
                ctx[:, sl] = pmat @ v[:, sl]
            x = ln(x + ctx @ W.wo.T, W.ln1_g, W.ln1_b)
            hdn = act(x @ W.w1.T)
            x = ln(x + hdn @ W.w2.T, W.ln2_g, W.ln2_b)
        return x

    def _linear_t(self, W, xc, xs):
        """(S, d_in) shares × W (d_out, d_in) -> shares at frac (trunc'd)."""
        yc, ys = self.p.linear(W, xc, xs)
        return self.p.trunc(yc, ys, 2 * self.p.frac)

    # ------------------------------------------------------------------
    def forward_private(self, x: np.ndarray) -> np.ndarray:
        """x: (S, d) client input (float). Returns (S, d) revealed output.

        Eager compatibility path: offline and online legs interleave per
        layer. Production serving should go through ``compile_session`` →
        ``preprocess`` → ``run`` so offline work pools across requests.
        """
        p = self.p
        f = p.frac
        S = x.shape[0]
        xc, xs = p.share_input(x)
        for W in self.weights:
            # ---- attention ------------------------------------------------
            qc, qs = self._linear_t(W.wq * self.scale_q, xc, xs)
            kc, ks = self._linear_t(W.wk, xc, xs)
            vc, vs = self._linear_t(W.wv, xc, xs)
            ctx_c = np.zeros((S, self.d), np.uint64)
            ctx_s = np.zeros((S, self.d), np.uint64)
            for h in range(self.h):
                sl = slice(h * self.hd, (h + 1) * self.hd)
                sc_, ss_ = p.matmul_private(
                    qc[:, sl], qs[:, sl],
                    kc[:, sl].T.copy(), ks[:, sl].T.copy(),
                )  # (S, S) at 2f
                pc_, ps_ = p.softmax_rows(sc_, ss_, S, in_scale=2 * f)
                oc_, os_ = p.matmul_private(pc_, ps_, vc[:, sl], vs[:, sl])
                oc_, os_ = p.trunc(oc_, os_, 2 * f)
                ctx_c[:, sl] = oc_
                ctx_s[:, sl] = os_
            ac, as_ = self._linear_t(W.wo, ctx_c, ctx_s)
            # residual + LN1 (post-norm)
            hc = SS.add_mod(xc, ac, p.t)
            hs = SS.add_mod(xs, as_, p.t)
            xc, xs = p.layernorm(hc, hs, W.ln1_g, W.ln1_b, in_scale=f)
            # ---- MLP -------------------------------------------------------
            h1c, h1s = p.linear(W.w1, xc, xs)  # (S, d_ff) at 2f
            gc_, gs_ = p.activation(self.activation, h1c, h1s, in_scale=2 * f)
            h2c, h2s = self._linear_t(W.w2, gc_, gs_)
            hc = SS.add_mod(xc, h2c, p.t)
            hs = SS.add_mod(xs, h2s, p.t)
            xc, xs = p.layernorm(hc, hs, W.ln2_g, W.ln2_b, in_scale=f)
        return p.reveal(xc, xs)
