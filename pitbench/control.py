"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, computed one fractional bit below
the configuration's fixed point (11 bits for 12), on one request of the
cell's frozen ops. It must come out as not correct.

    python3 pitbench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints, per seed, the numbers the run's check compares beside their
limits, and a last line of JSON with all of them. Needs no card and
nothing of the program: the reference is NumPy.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[1]


def reference_served(ops: List, inputs, index: int, *, t: int, frac: int):
    """Request ``index`` as the reference at ``frac`` fractional bits would
    serve it: each op's output as two shares mod t, the client's a
    uniform mask drawn from the seed."""
    import numpy as np

    from pitbench import workload as W
    from pitbench.reference import compare as C

    served = W.Served(index)
    masks = np.random.default_rng(inputs.seed + [3, index])
    tw = np.uint64(t)
    for op, case in zip(ops, W.cases(served, ops, inputs, outputs=False)):
        case.out_c = masks.integers(0, t, np.shape(case.xc), dtype=np.uint64)
        want = C.expected(case, t=t, frac=frac)
        served.outputs[op.index] = (case.out_c, (want + tw - case.out_c) % tw)
    return served


def control(cell: str, seed: int, *, root: Path = ROOT) -> dict:
    """The run's check when the reference one fractional bit below the
    configuration stands in for the program on one request of ``cell``."""
    from pitbench import harness
    from pitbench import workload as W

    spec = harness.load_spec(cell, root)
    priv = spec["config"]["privacy"]
    t, frac = priv["t"], priv["frac_bits"]
    ops = W.frozen(spec["ops"])
    inputs = W.Inputs(seed, t)
    served = [reference_served(ops, inputs, 0, t=t, frac=frac - 1)]
    correct, failed, checks = harness.check(served, ops, inputs, t=t,
                                            frac=frac)
    return {"correct": correct, "failed": failed, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    out = {}
    for seed in args.seeds:
        out[str(seed)] = got = control(args.workload, seed)
        c = got["checks"]
        print(f"control {args.workload} seed {seed}: mismatched_words "
              f"{c['mismatched_words']['value']} of "
              f"{c['words_compared']['value']} (limit "
              f"{c['mismatched_words']['limit']}), correct {got['correct']}",
              flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main())
