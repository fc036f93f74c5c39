"""AST lint for protocol-path RNG discipline.

Protocol-path RNG (over ``core/protocol.py``, ``core/session.py``,
``net/party.py``): ``proto-global-rng`` flags draws from a *global*
random stream — the numpy global RNG (``np.random.rand`` etc.), stdlib
``random``, and torch's default generator (``torch.rand``/``randn``/
``randint``/``randperm`` and their ``*_like`` forms called without a
``generator=``). Protocol randomness must come from per-party seeded
``Generator`` objects (``default_rng``/``torch.Generator`` construction
is the approved pattern), both for reproducibility and because a global
stream is shared mutable state across parties in-process, which silently
correlates "independent" masks.

The protocol-RNG half of the JAX package's ``analysis/jit_hygiene.py``,
with the same rule id, finding keys and path discovery. Its other half,
the lint of ``jax.jit``-compiled bodies (Python branches, host numpy
and casts on traced values), has no counterpart: the port traces no
bodies; its kernels are CUDA sources and the code around them runs
eagerly.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from repro_torch.analysis.report import Finding

#: protocol files the CI lint covers by default (repo-relative)
DEFAULT_PROTO_PATHS = (
    "src/repro_torch/core/protocol.py",
    "src/repro_torch/core/session.py",
    "src/repro_torch/net/party.py",
)

#: numpy constructors of a seeded generator (not draws)
_GLOBAL_RNG_OK = {"default_rng", "Generator", "SeedSequence",
                  "BitGenerator", "Philox", "PCG64"}


def _call_name(func: ast.expr) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _attr_chain(node: ast.expr) -> List[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def lint_proto_rng(path: str, rel: Optional[str] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    rel = rel or path
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        name = _call_name(node.func)
        if name in _GLOBAL_RNG_OK:
            continue
        hit = None
        if len(chain) >= 2 and chain[0] in ("np", "numpy") and \
                chain[1] == "random":
            hit = f"np.random.{name}"
        elif len(chain) == 2 and chain[0] == "random":
            hit = f"random.{name}"
        elif len(chain) == 2 and chain[0] == "torch" and \
                name.startswith("rand") and \
                not any(kw.arg == "generator" for kw in node.keywords):
            # torch.rand* with no generator= draws from the default one
            hit = f"torch.{name}"
        if hit:
            findings.append(Finding(
                "jit", "proto-global-rng", rel,
                getattr(node, "lineno", 0), hit,
                f"{hit}() draws from a global RNG in a protocol path — "
                f"use a per-party seeded Generator"))
    return findings


def run_jit_hygiene(root: str, proto_paths=None) -> List[Finding]:
    findings: List[Finding] = []
    for rel in (proto_paths or DEFAULT_PROTO_PATHS):
        p = rel if os.path.isabs(rel) else os.path.join(root, rel)
        if os.path.exists(p):
            findings.extend(lint_proto_rng(p, os.path.relpath(p, root)))
    return findings
