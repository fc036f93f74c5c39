"""Private serving: sequence-length buckets + preprocessed-bundle pools.

The plaintext ``ServeEngine`` batches token requests against jitted
prefill/decode; this is its privacy-plane sibling. Each sequence length
gets its own compiled :class:`~repro_torch.core.session.PiTSession` (shapes and
scales are resolved per bucket at compile time), and each bucket owns a
pool of single-use :class:`~repro_torch.core.session.PreprocessedBundle`\\ s.

The pool is refillable in the background (``refill_async``) so the
offline phase — the dominant cost — overlaps idle time between request
waves; ``serve`` then only pays the online phase per request. When a
bucket's pool runs dry the engine either preprocesses on demand
(``auto_refill=True``) or raises :class:`BundlePoolEmpty` so the caller
can shed load — the production behaviour for latency-SLO serving.

Locking is per bucket: each sequence length owns an independent
session (its own protocol, RNG and stats), so refill and serving of one
bucket never stall another. Within a bucket, offline refill and online
runs still serialize — the in-process protocol shares one RNG/stats
object, and correctness beats concurrency there.

The port of the JAX package's in-process ``PrivateServeEngine``: every
bucket garbles and evaluates on the engine's ``device``. The pipelined
two-party engine and the coarse schedule hook wait for later slices.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.session import PiTSession, PreprocessedBundle, compile
from repro_torch.serve.errors import BundlePoolEmpty


@dataclass
class PrivateRequest:
    x: np.ndarray  # (S, d) client-private embeddings
    result: Optional[np.ndarray] = None


class PrivateServeEngine:
    def __init__(self, model, *, buckets: Sequence[int] = (),
                 pool_target: int = 2, auto_refill: bool = False,
                 device=None):
        """``model``: a ``PrivateTransformer`` (server-owned weights).

        ``buckets`` pre-compiles sessions for those sequence lengths;
        other lengths compile lazily on first sight. ``pool_target`` is
        the per-bucket bundle level ``maintain`` refills to. ``device``
        (default: the model's, ``"cuda"`` unless the model was built for
        the CPU) is where every bucket garbles and evaluates.
        """
        self.model = model
        self.pool_target = pool_target
        self.auto_refill = auto_refill
        self.device = device if device is not None else \
            getattr(model, "device", "cuda")
        self._sessions: Dict[int, PiTSession] = {}
        self._pools: Dict[int, Deque[PreprocessedBundle]] = {}
        self._locks: Dict[int, threading.Lock] = {}
        self._meta = threading.Lock()  # guards bucket creation + hints
        # refill-queue depth (bundles scheduled, not yet pooled) and the
        # observed per-bundle preprocessing time, per bucket — the raw
        # material for the retry-after hint a shed carries
        self._refill_pending: Dict[int, int] = {}
        self._prep_ewma_s: Dict[int, float] = {}
        for S in buckets:
            self.session(S)

    # ------------------------------------------------------------------
    # buckets & pools
    # ------------------------------------------------------------------
    def session(self, seq_len: int) -> PiTSession:
        with self._meta:
            if seq_len not in self._sessions:
                self._sessions[seq_len] = compile(
                    self.model, shape=(seq_len, self.model.d), seed=seq_len,
                    device=self.device)
                self._pools[seq_len] = deque()
                self._locks[seq_len] = threading.Lock()
            return self._sessions[seq_len]

    def _bucket_lock(self, seq_len: int) -> threading.Lock:
        self.session(seq_len)
        return self._locks[seq_len]

    def pool_size(self, seq_len: int) -> int:
        with self._meta:
            return len(self._pools.get(seq_len, ()))

    def _note_refill(self, seq_len: int, count: int) -> None:
        with self._meta:
            self._refill_pending[seq_len] = (
                self._refill_pending.get(seq_len, 0) + count)

    def _note_prepped(self, seq_len: int, count: int, elapsed_s: float
                      ) -> None:
        with self._meta:
            self._refill_pending[seq_len] = (
                self._refill_pending.get(seq_len, 0) - count)
            if count > 0 and elapsed_s > 0:
                per = elapsed_s / count
                prev = self._prep_ewma_s.get(seq_len)
                self._prep_ewma_s[seq_len] = (
                    per if prev is None else 0.7 * prev + 0.3 * per)

    def retry_after_hint(self, seq_len: int) -> Optional[float]:
        """When is a dry bucket expected to have a bundle again? Refill
        queue depth times observed per-bundle preprocessing time — None
        until either has been observed (no data, no guess)."""
        with self._meta:
            depth = self._refill_pending.get(seq_len, 0)
            per = self._prep_ewma_s.get(seq_len)
        if per is None:
            return None
        return round(max(depth, 1) * per, 3)

    def preprocess(self, seq_len: int, count: int) -> int:
        """Synchronously add ``count`` bundles to the bucket's pool."""
        sess = self.session(seq_len)
        self._note_refill(seq_len, count)
        elapsed = 0.0
        try:
            with self._bucket_lock(seq_len):
                # span-backed timing: the EWMA reads the span's duration
                # (one timing path with the tracer instead of a
                # hand-rolled perf_counter delta)
                with obs.timer("engine.prep", bucket=seq_len,
                               bundles=count) as sp:
                    bundles = sess.preprocess(count)
                elapsed = sp.elapsed_s
                self._pools[seq_len].extend(bundles)
                return len(self._pools[seq_len])
        finally:
            self._note_prepped(seq_len, count, elapsed)

    def maintain(self, seq_len: int) -> int:
        """Top the bucket's pool back up to ``pool_target``.

        Deficit is computed under the bucket lock so concurrent refills
        don't both see it and overshoot the target.
        """
        sess = self.session(seq_len)
        with self._bucket_lock(seq_len):
            deficit = self.pool_target - len(self._pools[seq_len])
            if deficit > 0:
                self._note_refill(seq_len, deficit)
                sp = obs.timer("engine.prep", bucket=seq_len,
                               bundles=deficit)
                try:
                    self._pools[seq_len].extend(sess.preprocess(deficit))
                finally:
                    self._note_prepped(seq_len, deficit,
                                       sp.close().elapsed_s)
            return len(self._pools[seq_len])

    def refill_async(self, seq_len: int, count: Optional[int] = None
                     ) -> threading.Thread:
        """Refill the bucket's pool on a background thread."""
        def work():
            if count is None:
                self.maintain(seq_len)
            else:
                self.preprocess(seq_len, count)

        th = threading.Thread(target=work, daemon=True,
                              name=f"pit-refill-S{seq_len}")
        th.start()
        return th

    def _take_bundle(self, seq_len: int) -> PreprocessedBundle:
        """Pop one bundle; caller must hold the bucket lock."""
        pool = self._pools[seq_len]
        if pool:
            return pool.popleft()
        if self.auto_refill:
            return self._sessions[seq_len].preprocess(1)[0]
        raise BundlePoolEmpty(
            f"no preprocessed bundle for bucket S={seq_len} "
            f"(pool empty; call preprocess/refill_async or enable "
            f"auto_refill)",
            retry_after_s=self.retry_after_hint(seq_len))

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def serve(self, requests: List[PrivateRequest]) -> List[PrivateRequest]:
        """Serve a wave of requests, bucketed by sequence length.

        Requests of the same length form one batch against one session;
        each request consumes one pooled bundle (online phase only).
        """
        by_len: Dict[int, List[PrivateRequest]] = {}
        for r in requests:
            by_len.setdefault(int(np.asarray(r.x).shape[0]), []).append(r)
        for S, batch in by_len.items():
            sess = self.session(S)
            with self._bucket_lock(S):
                for r in batch:
                    bundle = self._take_bundle(S)
                    try:
                        r.result = sess.run(r.x, bundle)
                    except Exception:
                        if not bundle.consumed:
                            # e.g. bad request shape: the (expensive)
                            # bundle is still fresh — return it to the pool
                            self._pools[S].appendleft(bundle)
                        raise
        return requests

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def stats(self, seq_len: int):
        return self.session(seq_len).stats
