"""Serving-plane exceptions shared by the in-process engines and the
two-party runtime.

They live in their own dependency-free module so the two-party runtime
(which must *raise* the load-shed signal when a gateway sheds over the
wire) can import it without creating an import cycle with
the serve package (whose ``__init__`` imports the gateway, which
imports the endpoints).
"""

from __future__ import annotations

from typing import Optional


class BundlePoolEmpty(RuntimeError):
    """Load-shed signal: no preprocessed bundle (or no capacity) for the
    request's bucket.

    ``retry_after_s`` is the shedder's hint for when capacity is expected
    back — computed from the refill queue depth and the observed
    per-bundle preprocessing time, never a bare guess. ``scope`` says
    what was exhausted: ``"pool"`` (no bundle for a run), ``"prep"``
    (a bounded bundle pool refused more offline work) or ``"session"``
    (a gateway at its session cap refused the connection).
    """

    def __init__(self, message: str, *,
                 retry_after_s: Optional[float] = None,
                 scope: str = "pool"):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.scope = scope
