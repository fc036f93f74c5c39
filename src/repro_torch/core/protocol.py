"""The APINT protocol (and the PRIMER-style baseline it improves on).

Two-party PiT: the *client* owns the input and acts as garbler; the
*server* owns the weights and acts as evaluator. Values are additive
shares mod prime t (= the BFV plaintext modulus, so HE slots and shares
are the same algebra). Both parties run in-process; every message is
metered through ``ot.Channel`` and every GC workload is counted, which is
what the paper's latency/communication tables are built from.

Layer menu:
  linear_*      — DELPHI split: offline HE Linear(R1), online standard matmul
  beaver_matmul — private×private products (attention scores, PV)
  gc_apply      — garbled nonlinear function with share reconstruct/remask
  trunc         — exact deferred rescale through a tiny identity circuit
  layernorm     — full-GC baseline  OR  APINT offload (Fig. 4 ⑦–⑬):
                  mean/center on shares, variance via the HE inner-product
                  identity, β/γ affine via HE slots, only rsqrt·mul in GC.

Every layer is split into an explicit ``*_offline(...) -> correlation`` /
``*_online(x, correlation)`` pair. Offline methods depend only on shapes
and server weights (they garble circuits, precompute the HE masked
products and deal Beaver triples); online methods consume one correlation
and the live input shares. The single-call composites (``linear``,
``matmul_private``, ``gc_apply``, ``softmax_rows``, ``activation``,
``trunc``, ``layernorm``) are thin compatibility wrappers over the pairs;
the eager ``PrivateTransformer.forward_private`` runs on them.
``core/session.py`` builds the request-pooled preprocessing API on top.

This is the JAX package's ``core/protocol.py`` with the garbled-circuit
work on torch tensors: garbling labels come from the protocol's
``torch.Generator`` (seeded like its numpy ``default_rng``), garbling and
evaluation run on ``device``. Every numpy draw (shares, masks, ``r1``,
Beaver triples) is made in the reference's order and every message is
metered at the reference's sizes on wire v1 and v2, so a session with
the same seed reveals the same outputs and ledgers. BFV key generation
(at init) and the ``use_he_offline`` linear run on ``device`` through the
port's NTT (``core/he.py``), with their own ``torch.Generator`` (see
:func:`he_seed`), so the numpy draws stay in the reference's order.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import PrivacyConfig
from repro_torch import obs
from repro_torch.core import garble as G
from repro_torch.core import he as HE
from repro_torch.core import secret_sharing as SS
from repro_torch.core.circuits import arith, nonlinear as NL
from repro_torch.core.circuits.builder import CircuitBuilder, Word
from repro_torch.core.circuits.shares import (
    gc_word_bits,
    input_shared_word,
    output_shared,
)
from repro_torch.core.netlist import Netlist
from repro_torch.core.ot import (
    Channel, choose_labels, ot_labels,
    BASE_OT_A_BYTES, BASE_OT_B_BYTES, ot_v2_request_bytes,
    ot_v2_response_bytes,
)
from repro_torch.core.wireformat import (
    SEED_STREAM_BYTES, TABLE_DELTA_WORDS, tables_delta_anchor_bytes,
)


@dataclass
class PhaseStats:
    """One protocol phase: its channel ledger and wall time."""

    channel: Channel = field(default_factory=Channel)
    t_s: float = 0.0

    def comm_snapshot(self) -> Dict[str, object]:
        return {
            "total": self.channel.total,
            "c2s": self.channel.client_to_server,
            "s2c": self.channel.server_to_client,
            "by_tag": dict(self.channel.by_tag),
        }


class Stats:
    """Phase-scoped protocol accounting.

    All traffic and wall time is attributed to an explicit phase
    (``offline`` or ``online``) through the :meth:`phase` context manager
    rather than ad-hoc field mutation; ``channel_offline`` /
    ``t_offline_s`` etc. remain as read-only compatibility views. Timing
    is span-backed (``obs.timer``, monotonic) and re-entrant: nested
    ``phase`` blocks of the same name accumulate wall time exactly once.
    """

    def __init__(self):
        self.offline = PhaseStats()
        self.online = PhaseStats()
        self.gc_and_gates = 0
        self.gc_gates = 0
        self.gc_instances_gates = 0  # gates × instances actually executed
        self.gc_instances_ands = 0
        self.he_pt_muls = 0
        self.he_encrypts = 0
        self.he_decrypts = 0
        self.per_fn: Dict[str, Dict[str, int]] = {}
        self._depth: Dict[str, int] = {"offline": 0, "online": 0}
        # v2 wire: the IKNP base-OT exchange happens once per session,
        # lazily at the first online OT batch — mirrored here so the
        # oracle meters it exactly once too
        self.ot_base_metered = False

    # -- compatibility views -------------------------------------------
    @property
    def channel_offline(self) -> Channel:
        return self.offline.channel

    @property
    def channel_online(self) -> Channel:
        return self.online.channel

    @property
    def t_offline_s(self) -> float:
        return self.offline.t_s

    @property
    def t_online_s(self) -> float:
        return self.online.t_s

    def fn(self, name: str) -> Dict[str, int]:
        return self.per_fn.setdefault(
            name, {"and": 0, "gates": 0, "instances": 0, "table_bytes": 0}
        )

    def _phase(self, name: str) -> PhaseStats:
        if name == "offline":
            return self.offline
        if name == "online":
            return self.online
        raise ValueError(f"unknown phase {name!r}")

    @contextmanager
    def phase(self, name: str):
        """Time a block into the named phase (outermost block wins).

        Span-backed: the outermost block opens an ``obs.timer`` span, so
        with tracing on every phase block shows up in the trace (and op
        spans opened inside nest under it); with tracing off the timer
        is an unrecorded monotonic measurement — either way ``t_s``
        accumulates exactly once per outermost block.
        """
        ph = self._phase(name)
        self._depth[name] += 1
        sp = obs.timer(name) if self._depth[name] == 1 else None
        try:
            yield ph
        finally:
            self._depth[name] -= 1
            if sp is not None:
                sp.close()
                ph.t_s += sp.elapsed_s

    def comm_snapshot(self) -> Dict[str, Dict[str, object]]:
        """Copy of both phase ledgers (for before/after diffing in tests)."""
        return {
            "offline": self.offline.comm_snapshot(),
            "online": self.online.comm_snapshot(),
        }


def bits_of(vals: np.ndarray, k: int, t: int) -> np.ndarray:
    """Share residues (I, n) mod t -> (I, n*k) LSB-first bits. k <= 62.

    Public: the two-party runtime (:mod:`repro.net`) packs its GC input
    words with the exact same bit layout on both endpoints.
    """
    v = np.asarray(vals, np.uint64)
    shifts = np.arange(k, dtype=np.uint64)
    out = ((v[..., None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return out.reshape(*v.shape[:-1], v.shape[-1] * k)


def words_from_bits(bits: np.ndarray, k: int, t: int) -> np.ndarray:
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // k, k).astype(np.uint64)
    shifts = np.arange(k, dtype=np.uint64)
    vals = np.sum(b << shifts, axis=-1, dtype=np.uint64)
    return np.mod(vals, np.uint64(t))


# ---------------------------------------------------------------------------
# offline correlations (the bundle parts consumed by the online phase)
# ---------------------------------------------------------------------------


@dataclass
class LinearCorrelation:
    """DELPHI linear-layer preprocessing: Enc(R1) round already metered."""

    Wmod: np.ndarray
    r1: np.ndarray
    s_mask: np.ndarray
    client_y: np.ndarray  # W·R1 − s_mask (client's offline output share)
    bias_q: Optional[np.ndarray] = None


@dataclass
class BeaverCorrelation:
    trip: SS.BeaverTriple


@dataclass
class GCCorrelation:
    """A garbled netlist batch plus fresh output masks for one use."""

    net: Netlist
    gcirc: G.GarbledCircuit
    masks: np.ndarray  # (I, n_out) — the client's output shares r
    mask_enc: np.ndarray  # t − r, wired as garbler inputs
    n_out: int

    @property
    def instances(self) -> int:
        return self.masks.shape[0]


@dataclass
class LayerNormCorrelation:
    offload: bool
    gc: GCCorrelation
    bq: np.ndarray
    gq: Optional[np.ndarray] = None  # offload: γ at scale f
    raw_e: Optional[np.ndarray] = None  # full-GC: (I, 2n) γ/β words
    he_mask: Optional[np.ndarray] = None  # offload: inner-product mask
    inv_n: int = 0
    in_scale: int = 0


def he_seed(seed: int) -> int:
    """Seed of a protocol's HE generator: derived from the protocol seed
    without drawing from its numpy generator, and distinct from the label
    generator's (which is ``seed`` itself), so the secret key's
    randomness is not the garbling labels'."""
    return int(np.random.SeedSequence([seed, 0x4845]).generate_state(
        1, np.uint64)[0] >> 1)


class PiTProtocol:
    def __init__(self, pcfg: PrivacyConfig, *, he_params: Optional[HE.BFVParams] = None,
                 seed: int = 0, device="cuda", wire_version: int = 1,
                 compression: bool = True):
        self.pcfg = pcfg
        self.params = he_params or HE.make_params(
            n=pcfg.he_poly_n, num_primes=pcfg.he_num_primes,
            t_bits=pcfg.he_t_bits,
        )
        self.t = self.params.t
        self.k = gc_word_bits(self.t)
        self.frac = pcfg.frac_bits
        self.rng = np.random.default_rng(seed)
        #: garbling labels: drawn on the host, so a seed gives the same
        #: circuits on every device
        self.gen = torch.Generator().manual_seed(seed)
        self.device = torch.device(device)
        #: wire-format revision this protocol *meters* (the net layer
        #: negotiates the same number at hello): 1 = raw label/table
        #: streams + sim-OT blocks; 2 = seed streams, delta-encoded table
        #: batches and IKNP OT (see repro.net.wire). The ledger test
        #: asserts the wire equals this meter, so both must move together.
        self.wire_version = wire_version
        #: v2 sub-knob: seed-stream/delta-table compression of the
        #: offline garbling stream (IKNP + coalescing stay on when off)
        self.compression = compression
        self.stats = Stats()
        #: HE randomness (keys, encryption noise), drawn on the host
        self.he_gen = torch.Generator().manual_seed(he_seed(seed))
        self.sk, self.pk = HE.keygen(self.params, self.he_gen, self.device)
        self._netlist_cache: Dict[str, Netlist] = {}
        #: the endpoints of one party (a pipelined offline/online pair, a
        #: server's evaluator threads) may first-build a netlist at once
        self._netlist_lock = threading.RLock()

    @property
    def style(self) -> str:
        return self.pcfg.mult_style

    @property
    def _ct_bytes(self) -> int:
        """Wire size of one BFV ciphertext (2 polys, RNS limbs, 8B words)."""
        return 2 * len(self.params.qs) * self.params.n * 8

    # ------------------------------------------------------------------
    # shares
    # ------------------------------------------------------------------
    def share_input(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Client-side fixed-point encode + share."""
        enc = SS.encode_fx(x, self.frac, self.t)
        c, s = SS.share(self.rng, enc, self.t)
        self.stats.channel_online.c2s(s.size * 8, "input-share")
        return c, s

    def reveal(self, c_share, s_share, scale_bits: Optional[int] = None) -> np.ndarray:
        v = SS.reconstruct(c_share, s_share, self.t)
        return SS.decode_fx(v, self.frac, self.t,
                            scale_bits if scale_bits is not None else self.frac)

    # ------------------------------------------------------------------
    # DELPHI linear layer (server weights)
    # ------------------------------------------------------------------
    def quantize_weight(self, W: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(Wq signed fixed-point, Wmod residues) — bundle-invariant, so
        sessions compute it once and share it across correlations."""
        Wq = np.round(np.asarray(W, np.float64) * (1 << self.frac)).astype(np.int64)
        return Wq, np.mod(Wq, self.t).astype(np.uint64)

    def linear_offline(self, W: Optional[np.ndarray], x_shape: Tuple[int, ...],
                       bias: Optional[np.ndarray] = None,
                       use_he_offline: bool = False,
                       quantized: Optional[Tuple[np.ndarray, np.ndarray]] = None
                       ) -> LinearCorrelation:
        """Offline half of ``y = W x + b``: client sends Enc(R1); server
        computes Enc(W·R1 − s_mask) (he_matvec for small dims or
        metered-equivalent modular math); client decrypts its share.
        Depends only on the input *shape*, never the input. ``quantized``
        is a cached :meth:`quantize_weight` result; when given, ``W`` may
        be None."""
        Wq, Wmod = quantized if quantized is not None else self.quantize_weight(W)
        d_out, d_in = Wq.shape
        with self.stats.phase("offline"), \
                obs.span("linear_offline", d_out=int(d_out), d_in=int(d_in)):
            r1 = self.rng.integers(0, self.t, x_shape, dtype=np.uint64)
            ct_count = math.ceil(r1.size / self.params.n)
            ch = self.stats.channel_offline
            ch.c2s(ct_count * self._ct_bytes, "he-enc-r")
            if use_he_offline and r1.ndim == 1:
                p = self.params
                ct_r = HE.encrypt(p, self.pk,
                                  HE.encode_coeffs(p, r1, self.device),
                                  self.he_gen)
                outs = HE.he_matvec(p, ct_r, Wq)  # (k, blocks, n) pair
                blocks = outs[0].shape[1]
                self.stats.he_pt_muls += blocks
                self.stats.he_encrypts += 1
                # the client decrypts every product ciphertext but reads
                # only the packed inner-product coefficients
                polys = HE.decrypt(p, self.sk, outs,
                                   coeffs=HE.matvec_coeffs(p, d_in, d_out))
                self.stats.he_decrypts += blocks
                wr = polys.reshape(-1)[:d_out]
                ch.s2c(blocks * self._ct_bytes, "he-wr")
            else:
                # metered-equivalent path (big matrices): same math mod t
                wr = (SS.matmul_mod(Wmod, r1.reshape(-1, 1), self.t).reshape(-1)
                      if r1.ndim == 1 else SS.matmul_mod(r1, Wmod.T, self.t))
                blocks = math.ceil(wr.size / self.params.n)
                self.stats.he_pt_muls += blocks
                ch.s2c(blocks * self._ct_bytes, "he-wr")
            s_mask = self.rng.integers(0, self.t, wr.shape, dtype=np.uint64)
            client_y = SS.sub_mod(wr, s_mask, self.t)  # client's offline share
            bias_q = None
            if bias is not None:
                bias_q = SS.encode_fx(bias, 2 * self.frac, self.t)
        return LinearCorrelation(Wmod=Wmod, r1=r1, s_mask=s_mask,
                                 client_y=client_y, bias_q=bias_q)

    def linear_online(self, corr: LinearCorrelation, x_c, x_s
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Online half: server computes W(x − R1) + s_mask (+ b)."""
        with self.stats.phase("online"), \
                obs.span("linear_online", n=int(np.asarray(x_c).size)):
            x_open = SS.sub_mod(SS.add_mod(x_c, x_s, self.t), corr.r1, self.t)
            # (client sends x_c − r1; server adds its share → x − r1 opened)
            self.stats.channel_online.c2s(x_open.size * 8, "x-minus-r")
            wx = (SS.matmul_mod(corr.Wmod, x_open.reshape(-1, 1), self.t).reshape(-1)
                  if x_open.ndim == 1
                  else SS.matmul_mod(x_open, corr.Wmod.T, self.t))
            server_y = SS.add_mod(wx, corr.s_mask, self.t)
            if corr.bias_q is not None:
                server_y = SS.add_mod(
                    server_y, np.broadcast_to(corr.bias_q, server_y.shape), self.t
                )
        return corr.client_y, server_y  # scale 2·frac

    def linear(self, W: np.ndarray, x_c, x_s, bias: Optional[np.ndarray] = None,
               use_he_offline: bool = False):
        """y = W x + b at scale 2·frac (compat wrapper: offline + online)."""
        corr = self.linear_offline(W, x_c.shape, bias=bias,
                                   use_he_offline=use_he_offline)
        return self.linear_online(corr, x_c, x_s)

    # ------------------------------------------------------------------
    # Beaver matmul (private × private)
    # ------------------------------------------------------------------
    def beaver_offline(self, m: int, k: int, n: int) -> BeaverCorrelation:
        """Deal one (m,k)×(k,n) matmul triple (HE-based in production)."""
        with self.stats.phase("offline"), \
                obs.span("beaver_offline", m=m, k=k, n=n):
            trip = SS.deal_matmul_triple(self.rng, m, k, n, self.t)
            self.stats.channel_offline.s2c((m * k + k * n + m * n) * 8, "beaver")
        return BeaverCorrelation(trip)

    def matmul_private(self, xc, xs, yc, ys):
        m, k = xc.shape
        k2, n = yc.shape
        corr = self.beaver_offline(m, k, n)
        return self.beaver_online(corr, xc, xs, yc, ys)

    def beaver_online(self, corr: BeaverCorrelation, xc, xs, yc, ys
                      ) -> Tuple[np.ndarray, np.ndarray]:
        with self.stats.phase("online"), \
                obs.span("beaver_online", m=int(np.asarray(xc).shape[0])):
            z1, z2, opened = SS.beaver_matmul(xc, xs, yc, ys, corr.trip, self.t)
            self.stats.channel_online.c2s(opened // 2, "beaver-open")
            self.stats.channel_online.s2c(opened // 2, "beaver-open")
        return z1, z2  # scale doubles

    # ------------------------------------------------------------------
    # garbled nonlinear function
    # ------------------------------------------------------------------
    def build_fn_circuit(self, name: str, n_in: int, n_out: int,
                         body: Callable[[CircuitBuilder, List[Word]], List[Word]],
                         descale: int = 0, n_raw_e: int = 0) -> Netlist:
        """Share-reconstruct → body(ins, raws) → remask, cached by name.

        ``n_raw_e`` appends plain evaluator words (server-private values,
        e.g. γ/β in the full-GC LayerNorm), two's-complement encoded.
        """
        with self._netlist_lock:
            if name in self._netlist_cache:
                return self._netlist_cache[name]
            cb = CircuitBuilder(name)
            ins = [input_shared_word(cb, self.t, descale)
                   for _ in range(n_in)]
            raws = [cb.e_input_word(self.k) for _ in range(n_raw_e)]
            outs = body(cb, ins, raws) if n_raw_e else body(cb, ins)
            assert len(outs) == n_out
            for y in outs:
                output_shared(cb, Word(y.bits[: self.k]), self.t)
            net = self._netlist_cache[name] = cb.build()
            return net

    def gc_offline(self, net: Netlist, instances: int, n_out: int,
                   gcirc: Optional[G.GarbledCircuit] = None) -> GCCorrelation:
        """Garble + draw output masks + meter tables/label transfer.

        ``gcirc`` lets a session pass a slice of a batch-garbled circuit
        (one garbling call per cached netlist across the whole bundle
        batch); when omitted the netlist is garbled here.
        """
        I = instances
        st = self.stats
        standalone = gcirc is None
        with st.phase("offline"), \
                obs.span("gc_offline", netlist=net.name, instances=I,
                         and_gates=net.and_count,
                         garbles_here=standalone):
            if gcirc is None:
                gcirc = G.garble(net, self.gen, I, device=self.device)
            assert gcirc.num_instances == I
            masks = self.rng.integers(0, self.t, (I, n_out), dtype=np.uint64)
            mask_enc = SS.sub_mod(np.zeros_like(masks), masks, self.t)  # t − r
            if self.wire_version >= 2 and self.compression:
                # delta-encoded table batch: each op meters its linear
                # per-instance share; the slab's fixed anchor + the seed
                # record are metered at the slab site (gc_slab_offline),
                # or here when this call IS the slab (no outer batch)
                rows = max(net.and_count, 1)
                st.channel_offline.c2s(I * rows * 4 * TABLE_DELTA_WORDS,
                                       f"tables:{net.name}")
                if standalone:
                    st.channel_offline.c2s(
                        tables_delta_anchor_bytes(net.and_count),
                        f"tables:{net.name}")
                    st.channel_offline.c2s(SEED_STREAM_BYTES, "g-labels")
            else:
                st.channel_offline.c2s(gcirc.tables.numel() * 4,
                                       f"tables:{net.name}")
                # only the output-mask labels are offline-known garbler
                # input; labels for the live share xc can only flow online
                # (gc_online)
                st.channel_offline.c2s(I * n_out * self.k * 16, "g-labels")
            st.gc_and_gates += net.and_count
            st.gc_gates += net.num_gates
            st.gc_instances_ands += net.and_count * I
            st.gc_instances_gates += net.num_gates * I
            f = st.fn(net.name)
            f["and"] = net.and_count
            f["gates"] = net.num_gates
            f["instances"] += I
            f["table_bytes"] += gcirc.tables.numel() * 4
        return GCCorrelation(net=net, gcirc=gcirc, masks=masks,
                             mask_enc=mask_enc, n_out=n_out)

    def gc_slab_offline(self, net: Netlist) -> None:
        """Meter the per-slab fixed v2 offline costs (anchor + seed).

        A session garbles ONE slab per distinct netlist and slices it
        per op (``core/session.py``), while the wire runtime frames one
        delta-table segment and one seed-stream record per slab. The
        per-op :meth:`gc_offline` legs meter only their linear
        per-instance delta share, so the batch-fixed anchor bytes and
        the 32-byte seed record are metered here, once per slab — the
        same granularity the garbler frames them at.
        """
        if self.wire_version < 2 or not self.compression:
            return
        with self.stats.phase("offline"), \
                obs.span("gc_slab_offline", netlist=net.name):
            ch = self.stats.channel_offline
            ch.c2s(tables_delta_anchor_bytes(net.and_count),
                   f"tables:{net.name}")
            ch.c2s(SEED_STREAM_BYTES, "g-labels")

    def gc_online(self, corr: GCCorrelation, xc: np.ndarray, xs: np.ndarray,
                  raw_e: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """OT server labels, evaluate, decode. Returns (client, server) shares."""
        net, gcirc = corr.net, corr.gcirc
        k = self.k
        st = self.stats
        with st.phase("online"), \
                obs.span("gc_online", netlist=net.name,
                         instances=int(np.asarray(xc).shape[0])):
            g_bits = np.concatenate(
                [bits_of(xc, k, self.t), bits_of(corr.mask_enc, k, self.t)],
                axis=1,
            )
            assert g_bits.shape[1] == len(net.garbler_inputs)
            g_lab = G.encode_inputs(gcirc, net.garbler_inputs, g_bits)
            # labels for the client's live input share (the mask-label half
            # was already transferred with the tables during preprocessing)
            xc_bits = len(net.garbler_inputs) - corr.n_out * k
            st.channel_online.c2s(xc.shape[0] * xc_bits * 16, "g-labels")
            e_bits = bits_of(xs, k, self.t)
            if raw_e is not None:
                rv = np.mod(np.asarray(raw_e, np.int64), 1 << k).astype(np.uint64)
                e_bits = np.concatenate(
                    [e_bits, bits_of(rv, k, 1 << k)], axis=1
                )
            e_zero = G.input_zeros(gcirc, net.evaluator_inputs)
            if self.wire_version >= 2:
                # real IKNP extension: lazy one-time base OT (the
                # evaluator is the base-OT *sender*: A is s2c, the κ
                # B-elements come back c2s), then per-batch column
                # matrix u (16 B/OT, c2s like the old sim request) and
                # masked label pairs (32 B/OT s2c, down from 48)
                ch = st.channel_online
                if not st.ot_base_metered:
                    st.ot_base_metered = True
                    ch.s2c(BASE_OT_A_BYTES, "ot-base")
                    ch.c2s(BASE_OT_B_BYTES, "ot-base")
                n_ot = int(np.prod(e_bits.shape))
                ch.c2s(ot_v2_request_bytes(n_ot), f"ot:{net.name}")
                ch.s2c(ot_v2_response_bytes(n_ot), f"ot:{net.name}")
                e_lab = choose_labels(e_zero, gcirc.r[:, None, :], e_bits)
            else:
                e_lab = ot_labels(st.channel_online, e_zero,
                                  gcirc.r[:, None, :], e_bits,
                                  tag=f"ot:{net.name}")
            # packed active labels: one (wire_ids, (I, n, 4)) pair straight
            # into the device executor — no per-wire host-side dict work
            cw, c_lab = G.const_wires_labels(gcirc)
            wire_ids = np.concatenate([
                np.asarray(net.garbler_inputs, np.int64),
                np.asarray(net.evaluator_inputs, np.int64), cw])
            labels = torch.cat([g_lab, e_lab, c_lab], dim=1)
            out_lab = G.evaluate(net, gcirc.tables, (wire_ids, labels))
            out_bits = G.decode_outputs(gcirc, out_lab)
            server_share = words_from_bits(out_bits, k, self.t)
        return corr.masks, server_share  # client share = r (masks)

    # ------------------------------------------------------------------
    # cached netlist builders (shared by wrappers and sessions)
    # ------------------------------------------------------------------
    def gc_apply(self, net: Netlist, xc: np.ndarray, xs: np.ndarray,
                 n_out: int, raw_e: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """xc/xs: (I, n_in) share residues mod t. Returns (I, n_out) shares.

        Client garbles (offline), server evaluates (online). Instances are
        batched — the paper's coarse-grained row mapping. ``raw_e``:
        (I, n_raw) signed int64 server-private values (two's complement).
        """
        corr = self.gc_offline(net, xc.shape[0], n_out)
        return self.gc_online(corr, xc, xs, raw_e=raw_e)

    def softmax_net(self, row_len: int, in_scale: int) -> Netlist:
        def body(cb, ins):
            return _softmax_body(cb, ins, self.frac, self.style)

        return self.build_fn_circuit(
            f"softmax{row_len}", row_len, row_len, body,
            descale=in_scale - self.frac,
        )

    def activation_net(self, kind: str, in_scale: int) -> Netlist:
        def body(cb, ins):
            if kind == "gelu":
                return [_gelu_body(cb, ins[0], self.frac, self.style)]
            return [_silu_body(cb, ins[0], self.frac, self.style)]

        return self.build_fn_circuit(
            f"{kind}", 1, 1, body, descale=in_scale - self.frac
        )

    def trunc_net(self, in_scale: int) -> Netlist:
        def body(cb, ins):
            return [ins[0]]

        return self.build_fn_circuit(
            f"trunc_s{in_scale}", 1, 1, body, descale=in_scale - self.frac
        )

    def layernorm_full_net(self, n: int, in_scale: int) -> Netlist:
        def body(cb, ins, raws):
            return _layernorm_body(cb, ins, self.frac, self.style,
                                   raws[:n], raws[n:])

        return self.build_fn_circuit(
            f"layernorm_full{n}", n, n, body,
            descale=in_scale - self.frac, n_raw_e=2 * n,
        )

    def layernorm_reduced_net(self, n: int, in_scale: int) -> Netlist:
        f = self.frac
        sc_ = in_scale + f
        return self.build_fn_circuit(
            f"layernorm_reduced{n}_s{in_scale}", n + 1, n,
            _make_ln_reduced(f, self.style, 2 * sc_, sc_), descale=0,
        )

    # ------------------------------------------------------------------
    # composite layers: offline/online pairs
    # ------------------------------------------------------------------
    def softmax_offline(self, row_len: int, in_scale: int, instances: int,
                        gcirc: Optional[G.GarbledCircuit] = None
                        ) -> GCCorrelation:
        return self.gc_offline(self.softmax_net(row_len, in_scale),
                               instances, row_len, gcirc)

    def softmax_rows(self, sc, ss, row_len: int, in_scale: int):
        """(I, n) shares at scale `in_scale` -> softmax shares at frac."""
        corr = self.softmax_offline(row_len, in_scale, sc.shape[0])
        return self.gc_online(corr, sc, ss)

    def activation_offline(self, kind: str, in_scale: int, n_elems: int,
                           gcirc: Optional[G.GarbledCircuit] = None
                           ) -> GCCorrelation:
        return self.gc_offline(self.activation_net(kind, in_scale),
                               n_elems, 1, gcirc)

    def activation_online(self, corr: GCCorrelation, xc, xs):
        oc, os_ = self.gc_online(corr, xc.reshape(-1, 1), xs.reshape(-1, 1))
        return oc.reshape(xc.shape), os_.reshape(xs.shape)

    def activation(self, kind: str, xc, xs, in_scale: int):
        """Elementwise GeLU/SiLU on shares of any shape (batched rows)."""
        corr = self.activation_offline(kind, in_scale, xc.size)
        return self.activation_online(corr, xc, xs)

    def trunc_offline(self, in_scale: int, n_elems: int,
                      gcirc: Optional[G.GarbledCircuit] = None
                      ) -> GCCorrelation:
        return self.gc_offline(self.trunc_net(in_scale), n_elems, 1, gcirc)

    def trunc_online(self, corr: GCCorrelation, xc, xs):
        oc, os_ = self.gc_online(corr, xc.reshape(-1, 1), xs.reshape(-1, 1))
        return oc.reshape(xc.shape), os_.reshape(xs.shape)

    def trunc(self, xc, xs, in_scale: int):
        """Exact GC truncation back to scale frac (elementwise)."""
        corr = self.trunc_offline(in_scale, xc.size)
        return self.trunc_online(corr, xc, xs)

    def layernorm_offline(self, n: int, instances: int, in_scale: int,
                          gamma, beta,
                          gcirc: Optional[G.GarbledCircuit] = None
                          ) -> LayerNormCorrelation:
        """All input-independent LayerNorm work for a (instances, n) input."""
        I = instances
        f = self.frac
        t = self.t
        st = self.stats
        if not self.pcfg.layernorm_offload:
            net = self.layernorm_full_net(n, in_scale)
            gcc = self.gc_offline(net, I, n, gcirc)
            with st.phase("offline"):
                gq = np.round(np.asarray(gamma, np.float64) * (1 << f)).astype(np.int64)
                bq = np.round(np.asarray(beta, np.float64) * (1 << f)).astype(np.int64)
                raw = np.concatenate([np.broadcast_to(gq, (I, n)),
                                      np.broadcast_to(bq, (I, n))], axis=1)
            return LayerNormCorrelation(offload=False, gc=gcc, bq=bq,
                                        raw_e=raw, in_scale=in_scale)

        # ---- APINT Fig. 4, offline legs -------------------------------
        with st.phase("offline"), \
                obs.span("layernorm_offline", n=n, instances=I):
            inv_n = int(round((1 << f) / n))
            gq = SS.encode_fx(np.asarray(gamma), f, t)
            bq = SS.encode_fx(np.asarray(beta), f, t)
            # ⑩ Enc(R2') for the γ⊙r' slot products is sent ahead of time
            ct_blocks = math.ceil(I * n / self.params.n)
            st.channel_offline.c2s(ct_blocks * self._ct_bytes, "he-ln-r")
            st.he_pt_muls += ct_blocks
            # ⑧ Enc of the client's centered share for the inner product
            st.channel_offline.c2s(I * self._ct_bytes, "he-enc-centered")
            st.he_encrypts += I
            he_mask = self.rng.integers(0, t, I, dtype=np.uint64)
        gcc = self.gc_offline(self.layernorm_reduced_net(n, in_scale), I, n, gcirc)
        return LayerNormCorrelation(offload=True, gc=gcc, gq=gq, bq=bq,
                                    he_mask=he_mask, inv_n=inv_n,
                                    in_scale=in_scale)

    def layernorm_online(self, corr: LayerNormCorrelation, xc, xs):
        t = self.t
        st = self.stats
        if not corr.offload:
            oc, os_ = self.gc_online(corr.gc, xc, xs, raw_e=corr.raw_e)
            return oc, os_

        # ---- APINT Fig. 4 ⑦–⑬, online legs ----------------------------
        with st.phase("online"), \
                obs.span("layernorm_online", n=int(xc.shape[1]),
                         instances=int(xc.shape[0])):
            I, n = xc.shape
            f = self.frac
            in_scale = corr.in_scale
            # ⑦ mean & center on shares (standard local ops): ×round(2^f/n)
            mu_c = SS.scalar_mul_mod(corr.inv_n, _row_sum(xc, t), t)
            mu_s = SS.scalar_mul_mod(corr.inv_n, _row_sum(xs, t), t)
            # centered x' at scale Sc = in_scale + f
            cxc = SS.sub_mod(SS.scalar_mul_mod(1 << f, xc, t), mu_c[:, None], t)
            cxs = SS.sub_mod(SS.scalar_mul_mod(1 << f, xs, t), mu_s[:, None], t)
            # ⑧⑨ variance via HE inner product: Σx'² = Σu² + 2⟨u, r'⟩ + Σr'²
            cross_c, cross_s = self._he_inner_online(cxc, cxs, corr.he_mask)
            var_c = SS.add_mod(_row_sum_sq(cxc, t),
                               SS.scalar_mul_mod(2, cross_c, t), t)
            var_s = SS.add_mod(_row_sum_sq(cxs, t),
                               SS.scalar_mul_mod(2, cross_s, t), t)
            var_c = SS.scalar_mul_mod(corr.inv_n, var_c, t)  # scale 2·Sc + f
            var_s = SS.scalar_mul_mod(corr.inv_n, var_s, t)
            # ⑩⑪ γ·x' via HE slots: γ⊙r' offline, γ⊙u server-local
            gxc = _rowwise_mul(corr.gq, cxc, t)
            gxs = _rowwise_mul(corr.gq, cxs, t)
            in_c = np.concatenate([gxc, var_c[:, None]], axis=1)
            in_s = np.concatenate([gxs, var_s[:, None]], axis=1)
        # ⑫ reduced GC: rsqrt(var) × (γ·x')
        oc, os_ = self.gc_online(corr.gc, in_c, in_s)
        with st.phase("online"):
            # ⑬ + β (server-held parameter added to its share)
            os_ = SS.add_mod(os_, np.broadcast_to(corr.bq, os_.shape), t)
        return oc, os_

    def layernorm(self, xc, xs, gamma, beta, in_scale: int):
        """(I, n) shares at scale `in_scale` -> LayerNorm shares at frac.

        APINT offload when pcfg.layernorm_offload, else full-GC baseline
        (γ/β enter the circuit as raw evaluator words — they are the
        server's weights, so they cost full word×word multiplies).
        """
        corr = self.layernorm_offline(xc.shape[1], xc.shape[0], in_scale,
                                      gamma, beta)
        return self.layernorm_online(corr, xc, xs)

    def _he_inner_online(self, cxc, cxs, mask: np.ndarray):
        """Shares of ⟨client_row, server_row⟩ per row (Fig. 4 ⑧).

        The client's Enc(r'_row) was sent during preprocessing; online the
        server mul_plains with its reversed share and returns the masked
        cross term. ``mask`` is the offline-drawn server share.
        """
        I, n = cxc.shape
        st = self.stats
        # metered-equivalent modular math (exact same result as the HE path,
        # which tests exercise at small sizes through he.he_matvec):
        cross = np.array(
            [int(np.dot(cxc[i].astype(object), cxs[i].astype(object)) % self.t)
             for i in range(I)], dtype=np.uint64)
        st.he_pt_muls += I
        st.channel_online.s2c(I * self._ct_bytes, "he-cross")
        st.he_decrypts += I
        return SS.sub_mod(cross, mask, self.t), mask


# ---------------------------------------------------------------------------
# circuit bodies (pure functions of reconstructed words)
# ---------------------------------------------------------------------------


def _softmax_body(cb, ins, frac, style):
    mx = ins[0]
    for w in ins[1:]:
        mx = arith.max_word(cb, mx, w)
    es = []
    for w in ins:
        d = arith.sub(cb, w, mx)
        es.append(NL.exp_circuit(cb, d, frac, style))
    s = es[0]
    for w in es[1:]:
        s = arith.add(cb, s, w)
    inv = NL.reciprocal_circuit(cb, s, frac, style)
    return [arith.fx_mul(cb, w, inv, frac, style=style) for w in es]


def _gelu_body(cb, x, frac, style):
    # inline of nonlinear.gelu on an existing word
    from repro_torch.core.circuits.nonlinear import _fx, _gelu

    k = len(x)
    lo = cb.const_word(_fx(-4.0, frac, k), k)
    hi = cb.const_word(_fx(4.0, frac, k) - 1, k)
    xc = arith.mux(cb, arith.lt_signed(cb, x, lo), lo, x)
    xc = arith.mux(cb, arith.lt_signed(cb, hi, xc), hi, xc)
    xs = arith.add_const(cb, xc, _fx(4.0, frac, k))
    segs = 16
    seg_bits = 4
    lo_bit = frac + 3 - seg_bits
    idx = Word(tuple(xs[lo_bit + i] for i in range(seg_bits)))
    width = 8.0 / segs
    slopes, intercepts = [], []
    for s in range(segs):
        a = -4.0 + s * width
        ga, gb = _gelu(a), _gelu(a + width)
        m = (gb - ga) / width
        slopes.append(_fx(m, frac, k))
        intercepts.append(_fx(ga - m * a, frac, k))

    def lut(tbl):
        level = [cb.const_word(v, k) for v in tbl]
        for bit in idx:
            level = [arith.mux(cb, bit, level[i + 1], level[i])
                     for i in range(0, len(level), 2)]
        return level[0]

    y = arith.fx_mul(cb, xc, lut(slopes), frac, style=style)
    return arith.add(cb, y, lut(intercepts))


def _silu_body(cb, x, frac, style):
    from repro_torch.core.circuits.nonlinear import _fx

    k = len(x)
    lo = cb.const_word(_fx(-6.0, frac, k), k)
    hi = cb.const_word(_fx(6.0, frac, k) - 1, k)
    xc = arith.mux(cb, arith.lt_signed(cb, x, lo), lo, x)
    xc = arith.mux(cb, arith.lt_signed(cb, hi, xc), hi, xc)
    xs = arith.add_const(cb, xc, _fx(6.0, frac, k))
    segs, seg_bits, int_bits = 32, 5, 4
    lo_bit = frac + int_bits - seg_bits  # 16-range
    idx = Word(tuple(xs[frac + int_bits - seg_bits + i] for i in range(seg_bits)))
    width = 16.0 / segs

    def f(v):
        vv = max(min(v, 6.0), -6.0)
        return vv / (1.0 + math.exp(-vv))

    slopes, intercepts = [], []
    for s in range(segs):
        a = -6.0 + s * width
        b = min(a + width, 6.0)
        fa, fb = f(a), f(b)
        m = (fb - fa) / (b - a) if b > a else 0.0
        slopes.append(_fx(m, frac, k))
        intercepts.append(_fx(fa - m * a, frac, k))

    def lut(tbl):
        level = [cb.const_word(v, k) for v in tbl]
        for bit in idx:
            level = [arith.mux(cb, bit, level[i + 1], level[i])
                     for i in range(0, len(level), 2)]
        return level[0]

    y = arith.fx_mul(cb, xc, lut(slopes), frac, style=style)
    return arith.add(cb, y, lut(intercepts))


def _layernorm_body(cb, ins, frac, style, gammas, betas):
    """Full-GC LayerNorm; γ/β are evaluator-supplied words."""
    n = len(ins)
    s = ins[0]
    for w in ins[1:]:
        s = arith.add(cb, s, w)
    sh = int(math.log2(n))
    mean = arith.shift_right_const(cb, s, sh, arithmetic=True)
    cs = [arith.sub(cb, w, mean) for w in ins]
    sq = [arith.fx_mul(cb, c, c, frac, style=style) for c in cs]
    v = sq[0]
    for w in sq[1:]:
        v = arith.add(cb, v, w)
    var = arith.shift_right_const(cb, v, sh, arithmetic=True)
    var = arith.add_const(cb, var, 1)
    rs = NL.rsqrt_circuit(cb, var, frac, style)
    outs = []
    for c, g, b in zip(cs, gammas, betas):
        y = arith.fx_mul(cb, c, rs, frac, style=style)
        y = arith.fx_mul(cb, y, g, frac, style=style)
        outs.append(arith.add(cb, y, b))
    return outs


def _make_ln_reduced(frac, style, var_descale, x_descale):
    def body(cb, ins):
        xs, var = ins[:-1], ins[-1]
        var = arith.shift_right_const(cb, var, var_descale, arithmetic=True)
        var = arith.add_const(cb, var, 1)
        rs = NL.rsqrt_circuit(cb, var, frac, style)
        outs = []
        for x in xs:
            xd = arith.shift_right_const(cb, x, x_descale, arithmetic=True)
            outs.append(arith.fx_mul(cb, xd, rs, frac, style=style))
        return outs

    return body


# ---------------------------------------------------------------------------
# share helpers
# ---------------------------------------------------------------------------


def _row_sum(x, t):
    return np.array(
        [int(np.sum(x[i].astype(object)) % t) for i in range(x.shape[0])],
        dtype=np.uint64,
    )


def _row_sum_sq(x, t):
    return np.array(
        [int(np.dot(x[i].astype(object), x[i].astype(object)) % t)
         for i in range(x.shape[0])],
        dtype=np.uint64,
    )


def _rowwise_mul(const_row, x, t):
    return ((const_row.astype(object)[None, :] * x.astype(object)) % t).astype(
        np.uint64
    )
