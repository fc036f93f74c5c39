"""Command line for the port's static-analysis suite.

Run from the repo root with ``src`` on the path::

    python -m repro_torch.analysis --all \
        --baseline src/repro_torch/analysis/baseline.json
    python -m repro_torch.analysis --netlists              # pillar 1 only
    python -m repro_torch.analysis --secretflow path.py    # specific files
    python -m repro_torch.analysis --all --json            # machine-readable
    python -m repro_torch.analysis --all --baseline PATH --update-baseline

Exit status: 0 when every finding is baselined (or none), 1 when new
findings exist, 2 on usage/internal error. The baseline ratchets counted
findings: a count may shrink freely but any growth fails the lint.

The port of the JAX package's ``analysis/cli.py`` (its
``scripts/lint.py``), with the same options and exit codes over the
port's files. ``--jit`` runs the protocol-RNG lint, the half of the
reference's jit-hygiene pass that has a counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.analysis import jit_hygiene, netcheck, secretflow
from repro_torch.analysis.report import (
    Baseline,
    Finding,
    diff,
    render_json,
    render_text,
)


def _detect_root(start: Optional[str] = None) -> str:
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(d, "src", "repro_torch")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start or os.getcwd())
        d = parent


def collect_findings(root: str, netlists: bool = False,
                     secret: bool = False, jit: bool = False,
                     paths: Optional[List[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    if netlists:
        findings.extend(netcheck.run_netcheck())
    if secret:
        findings.extend(secretflow.run_secretflow(root, paths or None))
    if jit:
        findings.extend(jit_hygiene.run_jit_hygiene(root, paths or None))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="PiT static analysis (PyTorch port)")
    ap.add_argument("--all", action="store_true",
                    help="run every pass (netlists + secretflow + jit)")
    ap.add_argument("--netlists", action="store_true",
                    help="netlist verifier + dataflow over the circuit "
                         "generator inventory")
    ap.add_argument("--secretflow", action="store_true",
                    help="secret-flow taint lint over the protocol files")
    ap.add_argument("--jit", action="store_true",
                    help="protocol RNG lint")
    ap.add_argument("--baseline", metavar="PATH",
                    help="baseline JSON of accepted findings")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline to accept current findings")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit a JSON report instead of text")
    ap.add_argument("--root", metavar="DIR",
                    help="repo root (default: auto-detect from cwd)")
    ap.add_argument("paths", nargs="*",
                    help="restrict secretflow/jit passes to these files")
    args = ap.parse_args(argv)

    if args.all:
        args.netlists = args.secretflow = args.jit = True
    if not (args.netlists or args.secretflow or args.jit):
        ap.error("select at least one pass (--all / --netlists / "
                 "--secretflow / --jit)")
    if args.update_baseline and not args.baseline:
        ap.error("--update-baseline needs --baseline PATH")

    root = _detect_root(args.root)
    try:
        findings = collect_findings(
            root, netlists=args.netlists, secret=args.secretflow,
            jit=args.jit, paths=args.paths or None)
    except SyntaxError as e:
        print(f"analysis: cannot parse {e.filename}: {e}", file=sys.stderr)
        return 2

    baseline = None
    if args.baseline:
        bp = args.baseline if os.path.isabs(args.baseline) else \
            os.path.join(root, args.baseline)
        if args.update_baseline:
            doc = Baseline.from_findings(findings)
            with open(bp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
                f.write("\n")
            print(f"baseline written: {bp} ({len(findings)} finding(s) — "
                  f"fill in each 'reason')")
            return 0
        if os.path.exists(bp):
            baseline = Baseline.load(bp)
        else:
            print(f"analysis: baseline {bp} not found", file=sys.stderr)
            return 2

    new = diff(findings, baseline)
    print(render_json(findings, new) if args.as_json
          else render_text(findings, new))
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
