#!/usr/bin/env python3
"""Serving-phase A/B of two checkouts of the port on one NVIDIA GPU.

    python3 chip_serve_ab.py BASE_DIR CHANGE_DIR [--pairs 2] [--json PATH]

Runs ``chip_smoke.py``'s serving phase (BERT-base width, 1 layer, S=8,
2 bundles, 2 requests) and then its profile phase (one more warm request
under ``torch.profiler``: the device's busy share) from each checkout in
turn, one process per run, in the order base, change, change, base,
repeated ``--pairs`` / 2 times, so both sides see the same card and
host. Each run builds its own kernels in its checkout. Prints one line
per run and a JSON summary (offline seconds, seconds per request, the
profiled request's wall time and busy share, launches, span totals) as
the last line; ``--json`` also writes it to a file. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

_RUN = """
import argparse, json, sys
sys.path.insert(0, {src!r}); sys.path.insert(0, {tree!r})
import chip_smoke as C
args = argparse.Namespace(layers=1, seq=8, requests=2, d=768, heads=12,
                          d_ff=3072, seed=0, json=None)
res, engine, x0 = C.phase_serve(args)
prof = C.phase_profile(engine, x0, args.seq) or {{}}
print("AB " + json.dumps(dict({{k: res[k] for k in (
    "offline_s", "online_s_per_request", "launches", "spans_s")}},
    profile={{k: prof.get(k) for k in ("wall_s", "device_busy_s",
                                     "busy_share")}})))
"""


def run(tree: Path, timeout: float) -> dict:
    code = _RUN.format(src=str(tree / "src"), tree=str(tree))
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"serving run in {tree} failed "
                           f"({out.returncode}):\n{out.stderr[-4000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")][-1]
    return json.loads(line[3:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--pairs", type=int, default=2,
                    help="base/change pairs, run as base, change, change, "
                         "base (even number)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds allowed per run")
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = {"base": args.base.resolve(), "change": args.change.resolve()}
    for t in trees.values():
        if not (t / "chip_smoke.py").exists():
            print(f"chip_serve_ab: {t} has no chip_smoke.py", file=sys.stderr)
            return 2
    order = ["base", "change", "change", "base"] * max(1, args.pairs // 2)
    runs = []
    for side in order:
        r = dict(side=side, **run(trees[side], args.timeout))
        runs.append(r)
        p = r["profile"]
        busy = ("not measured" if p["busy_share"] is None else
                f"{p['wall_s']:.2f} s, busy {100 * p['busy_share']:.2f}%")
        print(f"[ab] {side}: offline {r['offline_s']:.2f} s, requests "
              + ", ".join(f"{t:.2f}" for t in r["online_s_per_request"])
              + f" s; profiled request {busy}; launches {r['launches']}",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    summary = {"device": smi, "trees": {k: str(v) for k, v in trees.items()},
               "runs": runs}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(summary, indent=1))
    print(json.dumps({"device": smi, "runs": [
        {k: r[k] for k in ("side", "offline_s", "online_s_per_request",
                           "profile")} for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
