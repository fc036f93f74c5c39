"""A tiny checkout of the benchmark for its CPU tests: the real harness,
readers and reference, and a cell at a tiny width (d 4, 1 head, d_ff 4,
S 2, a 10-bit prime t, 3 fractional bits) brought as new files only: its
configuration, its traffic mix, its frozen ops, one more per-layer metric
and the ``BENCHMARK.json`` entries that name them. The port runs its plain walks
on the CPU; no test here needs a card."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELL = "tiny.gc.s2"
CONFIG = {
    "name": "tiny-pit", "hidden_size": 4, "num_attention_heads": 1,
    "intermediate_size": 4, "hidden_act": "gelu", "num_hidden_layers": 1,
    "privacy": {"he_t_bits": 10, "t": 769, "he_poly_n": 32,
                "he_num_primes": 1, "frac_bits": 3, "mult_style": "xfbq",
                "layernorm_offload": True},
    "wire": {"version": 2, "compression": True},
}
TRAFFIC = {"seq_len": 2}
#: the tiny layer's ops: [name, kind, [rows, cols], instances, in_scale]
OPS = [["L0.q.t", "trunc", [2, 4], 8, 6], ["L0.k.t", "trunc", [2, 4], 8, 6],
       ["L0.v.t", "trunc", [2, 4], 8, 6],
       ["L0.h0.softmax", "softmax", [2, 2], 2, 6],
       ["L0.h0.o.t", "trunc", [2, 4], 8, 6],
       ["L0.wo.t", "trunc", [2, 4], 8, 6],
       ["L0.ln1", "layernorm", [2, 4], 2, 3], ["L0.act", "gelu", [2, 4], 8, 6],
       ["L0.w2.t", "trunc", [2, 4], 8, 6],
       ["L0.ln2", "layernorm", [2, 4], 2, 3]]
#: a per-layer metric that exists only as the new file below
METRIC = "tiny.ops_per_request"
METRIC_SRC = '''"""GC ops served per request (a test's metric)."""


def read(v):
    return len(v.ops)
'''


def make_checkout(dest: Path, ops=OPS) -> Path:
    """``dest`` with BENCHMARK.json, pitbench/ and src/ (a link), plus
    the tiny cell's files (its frozen ops ``ops``)."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "pitbench", dest / "pitbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (dest / "src").symlink_to(ROOT / "src")
    (dest / "pitbench" / "configs" / "tiny-pit.json").write_text(
        json.dumps(CONFIG))
    (dest / "pitbench" / "traffic" / "s2tiny.json").write_text(
        json.dumps(TRAFFIC))
    (dest / "pitbench" / "ops" / f"{CELL}.json").write_text(
        json.dumps({"ops": ops}))
    (dest / "pitbench" / "metrics" / f"{METRIC}.py").write_text(METRIC_SRC)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-pit", "source": "a test",
                             "file": "pitbench/configs/tiny-pit.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny-pit",
                               "traffic": "s2tiny", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    bench["per_layer"].append({
        "name": METRIC, "unit": "ops", "better": "lower",
        "source": "program_counter", "layer": "circuits",
        "moves": "online_s", "workloads": [CELL]})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def args(trace: int = 0, seed: int = 2**31 + 77, seconds: float = 0.01):
    from pitbench import harness

    return harness.parse(["--workload", CELL, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)])
