"""Findings, baseline diffing and rendering for the static-analysis CLI.

A finding is keyed by ``(tool, rule, path, symbol)`` — deliberately
*without* the line number, so unrelated edits that shift lines don't
invalidate the baseline. Counted findings (e.g. removable-AND totals per
generator) carry a ``count``; a baselined key suppresses the finding as
long as the current count does not exceed the accepted one, so the
baseline doubles as a ratchet: counts may only go down without a
baseline update.

Baseline entries carry a mandatory ``reason`` string — the "explicitly
baselined with a comment" rule: nothing is grandfathered silently.

A copy of the JAX package's ``analysis/report.py`` (standard library
only). The port keeps its own baseline,
``src/repro_torch/analysis/baseline.json``.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Finding:
    tool: str  # "netcheck" | "secretflow" | "jit"
    rule: str  # short rule id, e.g. "secret-to-wire"
    path: str  # repo-relative file, or "netlist:<name>" for circuits
    line: int  # 1-based; 0 when the finding has no source location
    symbol: str  # enclosing function / generator name (baseline key part)
    message: str
    count: int = 1

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return (self.tool, self.rule, self.path, self.symbol)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.tool}/{self.rule}] {self.message}"

    def to_dict(self) -> Dict:
        return asdict(self)


@dataclass
class Baseline:
    """Accepted findings, loaded from / saved to a baseline JSON file
    (the port's: ``src/repro_torch/analysis/baseline.json``)."""

    entries: Dict[Tuple[str, str, str, str], Dict] = field(
        default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if data.get("version") != 1:
            raise ValueError(
                f"unsupported baseline version {data.get('version')!r} "
                f"in {path}")
        bl = cls()
        for e in data.get("findings", []):
            missing = [k for k in ("tool", "rule", "path", "symbol", "reason")
                       if k not in e]
            if missing:
                raise ValueError(
                    f"baseline entry {e!r} missing keys {missing} — every "
                    f"accepted finding needs an explicit reason")
            bl.entries[(e["tool"], e["rule"], e["path"], e["symbol"])] = e
        return bl

    @classmethod
    def from_findings(cls, findings: List[Finding],
                      reason: str = "TODO: justify") -> Dict:
        """Serializable baseline doc accepting ``findings`` as-is."""
        return {
            "version": 1,
            "findings": [
                {"tool": f.tool, "rule": f.rule, "path": f.path,
                 "symbol": f.symbol, "count": f.count, "reason": reason}
                for f in findings
            ],
        }

    def accepts(self, f: Finding) -> bool:
        e = self.entries.get(f.key)
        if e is None:
            return False
        return f.count <= int(e.get("count", 1))


def diff(findings: List[Finding],
         baseline: Optional[Baseline]) -> List[Finding]:
    """Findings not covered by the baseline (all of them when no baseline)."""
    if baseline is None:
        return list(findings)
    return [f for f in findings if not baseline.accepts(f)]


def render_text(findings: List[Finding], new: List[Finding]) -> str:
    lines = [f.render() for f in sorted(
        new, key=lambda f: (f.path, f.line, f.rule))]
    n_base = len(findings) - len(new)
    tail = (f"{len(new)} new finding(s), {n_base} baselined"
            if n_base else f"{len(new)} finding(s)")
    lines.append(tail if new or n_base else "clean: no findings")
    return "\n".join(lines)


def render_json(findings: List[Finding], new: List[Finding]) -> str:
    return json.dumps(
        {
            "total": len(findings),
            "new": len(new),
            "baselined": len(findings) - len(new),
            "findings": [f.to_dict() for f in findings],
            "new_findings": [f.to_dict() for f in new],
        },
        indent=2, sort_keys=True)
