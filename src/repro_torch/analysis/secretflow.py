"""AST taint analysis: secret material must not reach the wire or logs.

Sources (secret-typed values):

* attribute reads of known secret fields — the FreeXOR delta
  (``gcirc.r``), zero-labels (``input_zero``/``wire_zero``/``e_zero``),
  output masks (``masks``/``mask_enc``), linear masks (``r1``,
  ``s_mask``, ``he_mask``), the HE secret key (``sk``);
* calls that mint secret material — ``random_delta``, ``random_labels``,
  ``input_zeros``;
* garbling keys (``PRNGKey``/``_next_key`` calls, the ``.key`` attribute):
  a PRG seed that expands to *both* labels of a wire is equivalent to
  the FreeXOR delta — shipping it hands the evaluator every complement
  label (the wire-v2 seed-stream rule);
* draws from a party RNG (``*.rng.integers(...)`` etc.): every RNG draw
  in the protocol is share/mask material by construction.

Sanitizers (the approved masking/opening APIs — their *results* are safe
to transmit by protocol design, whatever went in):

* ``encode_inputs`` / ``choose_labels`` / ``ot_labels`` /
  ``const_wires_labels`` — bits become active labels (masked by the
  unknown wire-zero/delta);
* ``stream_seed`` — the mask-label stream seed (wire v2): it expands
  only to *active* labels the evaluator is entitled to, never a
  complement pair, so the seed itself is transmittable by design.
  Note ``pack_seed_stream`` is deliberately NOT a sanitizer — framing a
  garbling key as a seed-stream record must stay flagged;
* ``respond`` — ``IknpSender.respond``: each label in the masked pair
  is one-time-padded by a correlation-robust hash of the receiver's
  column;
* ``remask_output`` / ``reconstruct_shared`` / ``output_shared`` /
  ``decode_outputs`` — the share-opening identities;
* ``ct_pack`` / ``ct_pack_rows`` — HE encryption (simulated);
* ``deal_matmul_triple`` — Beaver dealing: the ``*1`` halves exist to be
  sent.

Public projections: reading ``.tables`` / ``.output_perm`` / ``.net`` off
a tainted object is clean — garbled tables and permute bits are exactly
the transmittable part of a ``GarbledCircuit``.

Sinks: transport sends (``send``/``sendall``/``_send_control``/
``_send_sim``/``_send_segs``/``write``), log calls (``print``,
``logging``/``logger``/``log``/``warnings`` methods), trace-span
attributes (``obs.span``/``instant``/``timer`` — traces are exported
artifacts, so a span attribute is a log-grade channel), and exception
construction. A separate rule (``exc-to-wire``) flags *any* exception
text or traceback flowing into a send — exception reprs interpolate
values, so shipping them to the peer is an exfiltration channel even
when no tracked secret is syntactically visible.

The analysis is per-function and flow-insensitive (assignment taint is
iterated to a fixpoint, then sinks are scanned), which is the right
cost/precision point for this codebase: protocol functions are short and
single-assignment-ish.

A copy of the JAX package's ``analysis/secretflow.py`` (standard library
only) whose default paths name the port's protocol, runtime and serving
files: the same sources, sanitizers and sinks, so a leak the reference
lint catches is caught in the port too.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.report import Finding

SECRET_ATTRS = {
    "sk", "r", "input_zero", "wire_zero", "e_zero",
    "masks", "mask_enc", "s_mask", "he_mask", "r1", "delta",
    "key",  # the garbling PRNG key: expands to both labels of every wire
}
SECRET_CALLS = {"random_delta", "random_labels", "input_zeros",
                "PRNGKey", "_next_key"}  # garbling-key mints
RNG_DRAWS = {"integers", "bits", "random", "normal", "uniform", "choice"}
SANITIZERS = {
    "encode_inputs", "choose_labels", "ot_labels", "const_wires_labels",
    "remask_output", "reconstruct_shared", "output_shared",
    "decode_outputs", "ct_pack", "ct_pack_rows", "deal_matmul_triple",
    "share",  # SS.share: x -> (fresh mask, x - mask), both OTP-uniform
    "stream_seed",  # v2 mask-label stream: expands to active labels only
    "respond",  # IknpSender.respond: labels OTP'd by the CRH of t⊕s·u
}
PUBLIC_ATTRS = {"tables", "output_perm", "net", "name", "shape", "dtype"}
SEND_SINKS = {"send", "sendall", "_send_control", "_send_sim",
              "_send_segs", "send_msg", "write"}
LOG_RECEIVERS = {"logging", "logger", "log", "warnings"}
#: tracing sinks (repro_torch.obs): span attributes are exported to trace
#: artifacts, so they are a log-grade exfiltration channel — sizes,
#: tags and counts only, never label/mask/key material
SPAN_SINKS = {"span", "instant", "timer"}

#: files the CI lint covers by default (repo-relative)
DEFAULT_PATHS = (
    "src/repro_torch/core/protocol.py",
    "src/repro_torch/core/session.py",
    "src/repro_torch/net/party.py",
    "src/repro_torch/net/wire.py",
    "src/repro_torch/net/faults.py",
    "src/repro_torch/net/resilience.py",
    "src/repro_torch/serve/__init__.py",
    "src/repro_torch/serve/errors.py",
    "src/repro_torch/serve/gateway.py",
    "src/repro_torch/serve/private_engine.py",
    "src/repro_torch/obs/__init__.py",
    "src/repro_torch/obs/tracer.py",
)


def _call_name(func: ast.expr) -> str:
    """Rightmost name of a call target: ``G.encode_inputs`` -> that."""
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


class _FunctionTaint:
    """Taint state for one function body."""

    def __init__(self, fn: ast.AST, path: str, qualname: str):
        self.fn = fn
        self.path = path
        self.qualname = qualname
        self.tainted: Set[str] = set()
        self.exc_names: Set[str] = set()  # `except E as e` bindings
        self.findings: List[Finding] = []
        # parameters named like secret fields carry secrets by convention
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
                if a.arg in SECRET_ATTRS:
                    self.tainted.add(a.arg)

    # -- expression classification -------------------------------------
    def is_tainted(self, node: ast.expr) -> bool:
        """Does this expression carry secret material?"""
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in SECRET_ATTRS:
                return True
            if node.attr in PUBLIC_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            if name in SANITIZERS:
                return False
            if name in SECRET_CALLS:
                return True
            if name in RNG_DRAWS and isinstance(node.func, ast.Attribute):
                chain = _attr_chain(node.func)
                if any("rng" in part for part in chain[:-1]):
                    return True
            return any(self.is_tainted(a) for a in node.args) or any(
                self.is_tainted(kw.value) for kw in node.keywords
            ) or self.is_tainted(node.func)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(v is not None and self.is_tainted(v)
                       for v in node.values)
        if isinstance(node, ast.JoinedStr):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, ast.FormattedValue):
            return self.is_tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        if isinstance(node, ast.IfExp):
            return self.is_tainted(node.body) or self.is_tainted(node.orelse)
        if isinstance(node, ast.Compare):
            return False  # booleans of secrets are a different (timing) story
        return False

    def mentions_exc_text(self, node: ast.AST) -> bool:
        """Exception text / traceback reaching this expression?
        ``type(e).__name__`` is allowed — a class name carries none of
        the interpolated values an exception repr does."""
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            if name == "type":
                return False
            if name in ("format_exc", "format_exception", "print_exc"):
                return True
        if isinstance(node, ast.Name):
            return node.id in self.exc_names
        return any(self.mentions_exc_text(c)
                   for c in ast.iter_child_nodes(node))

    # -- statement walk ------------------------------------------------
    def _bind(self, target: ast.expr, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, tainted)
        elif isinstance(target, ast.Subscript):
            # storing a secret into a container taints the container
            if tainted and isinstance(target.value, ast.Name):
                self.tainted.add(target.value.id)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, tainted)

    def propagate(self) -> None:
        for _ in range(4):  # fixpoint: taint only grows, small bodies
            before = len(self.tainted)
            for node in ast.walk(self.fn):
                if isinstance(node, ast.Assign):
                    t = self.is_tainted(node.value)
                    for tgt in node.targets:
                        self._bind(tgt, t)
                elif isinstance(node, ast.AnnAssign) and node.value:
                    self._bind(node.target, self.is_tainted(node.value))
                elif isinstance(node, ast.AugAssign):
                    if self.is_tainted(node.value):
                        self._bind(node.target, True)
                elif isinstance(node, ast.For):
                    self._bind(node.target, self.is_tainted(node.iter))
                elif isinstance(node, ast.withitem) and node.optional_vars:
                    self._bind(node.optional_vars,
                               self.is_tainted(node.context_expr))
                elif isinstance(node, ast.ExceptHandler) and node.name:
                    self.exc_names.add(node.name)
                elif isinstance(node, (ast.NamedExpr,)):
                    self._bind(node.target, self.is_tainted(node.value))
            if len(self.tainted) == before:
                break

    def scan_sinks(self) -> None:
        for node in ast.walk(self.fn):
            if isinstance(node, ast.Call):
                self._scan_call(node)
            elif isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc
                args = exc.args + [kw.value for kw in exc.keywords] \
                    if isinstance(exc, ast.Call) else [exc]
                for a in args:
                    if self.is_tainted(a):
                        self.findings.append(self._finding(
                            "secret-to-exception", node,
                            "secret-derived value interpolated into an "
                            "exception message"))
                        break

    def _scan_call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        args = list(node.args) + [kw.value for kw in node.keywords]
        if name in SEND_SINKS:
            for a in args:
                if self.is_tainted(a):
                    self.findings.append(self._finding(
                        "secret-to-wire", node,
                        f"secret-derived value reaches transport sink "
                        f"{name}() without an approved masking/opening "
                        f"API"))
                    break
            for a in args:
                if self.mentions_exc_text(a):
                    self.findings.append(self._finding(
                        "exc-to-wire", node,
                        f"exception text/traceback sent to the peer via "
                        f"{name}() — exception reprs interpolate values "
                        f"and can embed secrets"))
                    break
        if name in SPAN_SINKS:
            for a in args:
                if self.is_tainted(a):
                    self.findings.append(self._finding(
                        "secret-to-span", node,
                        f"secret-derived value recorded as a span "
                        f"attribute via {name}() — traces are exported "
                        f"artifacts; record sizes/tags/counts, never "
                        f"payloads"))
                    break
        is_log = name == "print" or (
            isinstance(node.func, ast.Attribute)
            and _attr_chain(node.func)[0] in LOG_RECEIVERS)
        if is_log:
            for a in args:
                if self.is_tainted(a):
                    self.findings.append(self._finding(
                        "secret-to-log", node,
                        f"secret-derived value reaches log sink {name}()"))
                    break

    def _finding(self, rule: str, node: ast.AST, msg: str) -> Finding:
        return Finding("secretflow", rule, self.path,
                       getattr(node, "lineno", 0), self.qualname, msg)


def _functions(tree: ast.Module):
    """Yield (qualname, node) for every function, outermost class-aware."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from walk(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)
    yield from walk(tree, "")


def lint_file(path: str, rel: Optional[str] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    rel = rel or path
    findings: List[Finding] = []
    for qual, fn in _functions(tree):
        ft = _FunctionTaint(fn, rel, qual)
        ft.propagate()
        ft.scan_sinks()
        findings.extend(ft.findings)
    return findings


def run_secretflow(root: str, paths=None) -> List[Finding]:
    import os

    findings: List[Finding] = []
    for rel in (paths or DEFAULT_PATHS):
        p = rel if os.path.isabs(rel) else os.path.join(root, rel)
        if not os.path.exists(p):
            continue
        findings.extend(lint_file(p, os.path.relpath(p, root)))
    return findings
