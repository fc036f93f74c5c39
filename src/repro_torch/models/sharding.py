"""Logical-axis sharding rules: the part the model code calls.

The JAX package's model code annotates every activation with *logical*
dim names (``shard(x, "batch", "act_seq", "act_embed")``) and a module
of rules resolves them to mesh axes per (config, shape, mesh). This is
the port of ``Rules``, ``active_rules``, ``use_rules``, ``axis_size_of``
and ``shard`` (``src/repro/models/sharding.py:36-107``).

On one device no rules are active, exactly as in the reference without a
mesh: ``shard`` returns its argument, ``axis_size_of`` returns 1 and
``active_rules()`` returns ``None``, so the model code runs unmodified.
The rule builders (``make_rules``, ``param_specs``,
``named_sharding_tree``) and the sharded layouts come with the
multi-device slice; until then ``shard`` refuses active rules instead of
silently ignoring them.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

Axes = Optional[Tuple[str, ...]]  # mesh axes for one logical name


@dataclass
class Rules:
    """Resolved logical-name -> mesh-axes mapping for one (cfg, shape, mesh).

    ``axis_sizes`` maps each mesh axis to its size (the reference reads the
    same from ``mesh.axis_names`` / ``mesh.devices.shape``)."""

    axis_sizes: Dict[str, int]
    table: Dict[str, Axes]


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
    n = 1
    for a in r.table.get(name) or ():
        n *= r.axis_sizes[a]
    return n


def shard(x, *names: Optional[str]):
    """Annotate ``x`` with the sharding for logical dims ``names``.

    Identity when no rules are active (one device): model code is
    unconditional. Sharded layouts are not ported yet, so active rules
    raise rather than leave a tensor unsharded where a mesh expects it.
    """
    if _ACTIVE is None:
        return x
    assert x.ndim == len(names), f"{tuple(x.shape)} vs {names}"
    raise NotImplementedError(
        f"sharded layouts wait for the port's multi-device slice ({names})")
