"""Run one cell of the benchmark once and print its result line.

    python3 pitbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file that entry names, its
traffic mix in ``pitbench/traffic/<mix>.json``, its frozen unit of work
in ``pitbench/ops/<cell>.json`` and each metric's reader in
``pitbench/metrics/<metric>.py``. A run sets up the program (kernels,
protocol, netlists, level plans and executors at the cell's instance
counts, one untimed warm request), serves requests in a closed loop with
one client for ``--seconds``, reads the device's peak memory, frees the
program's state and compares every output of every request served with
the plain reference. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` (spans on, the profiler over the window) its
per-layer metrics. Besides the contract's keys the result line carries
``power_limit`` (the card's name and power limit) and ``requests``: per
request served, its offline and online seconds and the process's CPU
seconds over it (the host's speed, where the CPU seconds follow the
wall's).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]

#: top-level modules that must not be loaded in the process that prints
#: the result: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class SpecError(RuntimeError):
    """The cell, its configuration, mix or a metric cannot be found."""


def load_spec(cell: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, mix and metrics, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SpecError(f"no workload {cell!r} in BENCHMARK.json")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "pitbench" / "traffic" / f"{w['traffic']}.json").read_text())
    ops = root / "pitbench" / "ops" / f"{cell}.json"
    if not ops.exists():
        raise SpecError(f"no frozen ops for {cell!r} at {ops}")

    def here(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if here(m) and m["moves"] in names]
    return dict(cell=w, config=cfg, traffic=traffic,
                ops=json.loads(ops.read_text())["ops"], end_to_end=e2e,
                per_layer=per_layer, root=root)


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``pitbench/metrics/<name>.py``."""
    path = root / "pitbench" / "metrics" / f"{name}.py"
    if not path.exists():
        raise SpecError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        "pitbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class View:
    """What a metric's reader reads: the run's clocks, counters, spans and
    device timeline (None where not traced), and the yardstick's
    inputs."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def requests(self) -> int:
        return len(self.served)

    def parts(self, phase: str):
        return [p for s in self.served for p in getattr(s, phase)]

    def phase_s(self, phase: str) -> float:
        """Seconds of one phase per request, over the whole window."""
        return sum(b - a for a, b in self.parts(phase)) * 1e-9 / self.requests

    def idle_share(self, phase: str) -> Optional[float]:
        if self.device is None:
            return None
        parts = self.parts(phase)
        total = sum(b - a for a, b in parts)
        busy = sum(self.device.busy_ns(a, b) for a, b in parts)
        return 100.0 * (total - busy) / total

    def host_self_idle_s(self, names, children) -> Optional[float]:
        """Per request: host seconds inside the named spans, less their
        ``children`` spans, during which the device ran nothing (the
        time the protocol's own host work holds the request)."""
        from pitbench.trace import subtract

        if self.device is None or self.spans is None:
            return None
        w0, w1 = self.window
        spans = [s for s in self.spans if w0 <= s.t0 and s.t1 <= w1]
        kids = [s for s in spans if s.name in children]
        total = 0
        for s in spans:
            if s.name not in names:
                continue
            inner = [(k.t0, k.t1) for k in kids
                     if k.tid == s.tid and s.t0 <= k.t0 and k.t1 <= s.t1]
            for a, b in subtract(s.t0, s.t1, inner):
                total += (b - a) - self.device.busy_ns(a, b)
        return total * 1e-9 / self.requests


def _device_line(device: str, chips: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def _power_limit() -> str:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return got.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _walks(p) -> List[dict]:
    """Every executor the run built, with its walk bounds and calls."""
    from pitbench import yardstick as Y

    out = []
    for net in list(p._netlist_cache.values()):
        for plan in getattr(net, "_level_plans", {}).values():
            for exe in plan._executors.values():
                for garble in (False, True):
                    meta = exe._garble_meta if garble else exe._eval_meta
                    bound, _ = Y.walk_bound_s(
                        meta.records.numel(), len(plan.source_ids),
                        plan.n_and, len(plan.out_rows), exe.instances,
                        garble)
                    out.append(dict(exe=exe, garble=garble, bound_s=bound))
    return out


def _calls(walks) -> List[int]:
    return [w["exe"].n_garble_calls if w["garble"] else w["exe"].n_eval_calls
            for w in walks]


def set_up(args, *, device: str = "cuda", root: Path = ROOT,
           t_start: Optional[float] = None):
    """Everything before the window: the cell's files, the program's
    protocol, the layer's ops and netlists, and one untimed warm request
    (which builds the level plans and executors at the cell's instance
    counts, and the kernels). Refuses a program whose plan of the layer
    is not the cell's frozen ops."""
    import types

    import torch

    from repro_torch import obs
    from repro_torch.config import PrivacyConfig
    from repro_torch.core.protocol import PiTProtocol

    from pitbench import workload as W

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(args.workload, root)
    cfg, traffic = spec["config"], spec["traffic"]
    metrics = spec["per_layer"] if args.trace else spec["end_to_end"]
    readers = {m["name"]: reader(m["name"], root) for m in metrics}
    tracer = obs.enable() if args.trace else None

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    priv = cfg["privacy"]
    pcfg = PrivacyConfig(
        he_t_bits=priv["he_t_bits"], he_poly_n=priv["he_poly_n"],
        he_num_primes=priv["he_num_primes"], frac_bits=priv["frac_bits"],
        mult_style=priv["mult_style"],
        layernorm_offload=priv["layernorm_offload"])
    ops = W.frozen(spec["ops"])
    planned = W.layer_ops(cfg, traffic["seq_len"], pcfg)
    diff = W.differences(ops, planned)
    if diff:
        raise SpecError("the program's plan of the layer is not the cell's "
                        "frozen unit of work: " + "; ".join(diff[:4]))
    for op, pl in zip(ops, planned):
        op.spec = pl.spec
    p = PiTProtocol(pcfg, seed=args.seed, device=device,
                    wire_version=cfg["wire"]["version"],
                    compression=cfg["wire"]["compression"])
    if p.t != priv["t"]:
        raise SpecError(f"the program's prime t={p.t} is not the "
                        f"configuration's {priv['t']}")
    ops = W.cut(W.with_nets(p, ops))
    groups = W.groups_of(ops)
    inputs = W.Inputs(args.seed, p.t)
    W.serve_request(p, groups, inputs, -1, sync)
    st = types.SimpleNamespace(
        args=args, device=device, spec=spec, metrics=metrics,
        readers=readers, tracer=tracer, sync=sync, p=p, t=p.t,
        frac=priv["frac_bits"], ops=ops, groups=groups, inputs=inputs,
        walks=_walks(p))
    st.calls0 = _calls(st.walks)
    st.ands0 = p.stats.gc_instances_ands
    st.bytes0 = p.stats.channel_offline.total + p.stats.channel_online.total
    st.setup_end = time.perf_counter_ns()
    st.setup_s = time.perf_counter() - t_start
    return st


def serve_window(st, seconds: float):
    """Requests in a closed loop with one client, until ``seconds`` have
    passed (the last one runs to its end). Returns the requests served
    and the window's ends (host perf_counter ns)."""
    from pitbench import workload as W

    served = []
    w0 = time.perf_counter_ns()
    t_end = w0 + int(seconds * 1e9)
    while not served or time.perf_counter_ns() < t_end:
        served.append(W.serve_request(st.p, st.groups, st.inputs,
                                      len(served), st.sync))
    return served, (w0, time.perf_counter_ns())


def check(served, ops, inputs, *, t: int, frac: int):
    """Every output of every request served against the reference; the
    numbers compared with their limits, and the requests that failed."""
    from pitbench import workload as W
    from pitbench.reference import compare as C

    got = {"mismatched_words": 0, "words_compared": 0,
           "ops_with_mismatch": 0}
    failed = 0
    for s in served:
        one = C.compare(W.cases(s, ops, inputs), t=t, frac=frac)
        failed += one["mismatched_words"] > 0
        for k in got:
            got[k] += one[k]
        s.outputs.clear()
    checks = {
        "mismatched_words": {"value": got["mismatched_words"],
                             "limit": C.MISMATCH_LIMIT},
        "ops_with_mismatch": {"value": got["ops_with_mismatch"]},
        "words_compared": {"value": got["words_compared"]},
    }
    correct = (got["mismatched_words"] <= C.MISMATCH_LIMIT
               and got["words_compared"] > 0)
    return bool(correct), failed, checks


def run_cell(args, *, device: str = "cuda", root: Path = ROOT,
             t_start: Optional[float] = None) -> dict:
    """Set up, serve the window, check; the result line's object, whose
    last key holds the numbers compared beside their limits."""
    import torch

    from repro_torch import obs

    from pitbench import trace as T
    from pitbench import workload as W

    st = set_up(args, device=device, root=root, t_start=t_start)
    prof = T.Profiler() if args.trace and device == "cuda" else None
    with prof if prof is not None else contextlib.nullcontext():
        served, (w0, w1) = serve_window(st, args.seconds)
    dev_line = _device_line(device, st.spec["cell"]["chips"])
    p = st.p
    view = View(
        served=served, window=(w0, w1), setup_s=st.setup_s,
        setup_end=st.setup_end, ops=st.ops, work=W.work(st.ops),
        and_gates=p.stats.gc_instances_ands - st.ands0,
        wire_bytes=(p.stats.channel_offline.total
                    + p.stats.channel_online.total - st.bytes0),
        walks=[dict(w, calls=c - c0) for w, c, c0
               in zip(st.walks, _calls(st.walks), st.calls0)],
        spans=T.spans_of(st.tracer) if st.tracer is not None else None,
        device=prof.timeline() if prof is not None else None,
        on_card=device == "cuda", tid=threading.get_ident())
    metrics = {}
    for m in st.metrics:
        v = st.readers[m["name"]](view)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"metrics": metrics, "device": dev_line}
    if args.trace:
        tl = view.device
        dev_line["busy_s"] = (sum(b - a for a, b in tl.busy) * 1e-9
                              if tl is not None else 0.0)
        dev_line["window_s"] = (w1 - w0) * 1e-9
        if tl is not None:
            result["breakdown"] = T.breakdown(tl, view.spans or [],
                                              (w0, w1), view.tid)
            result["trace_marker_drift_s"] = tl.drift_ns * 1e-9
        obs.disable()
    # the program's state goes before the reference runs
    ops, inputs, t, frac = st.ops, st.inputs, st.t, st.frac
    del st, p, view, prof
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    correct, failed, checks = check(served, ops, inputs, t=t, frac=frac)
    return {"correct": correct, "attempted": len(served), "failed": failed,
            **result,
            "power_limit": _power_limit() if device == "cuda" else "cpu",
            "requests": [_request_line(r) for r in served],
            "checks": checks}


def _request_line(r) -> List[float]:
    return [sum(b - a for a, b in r.offline) * 1e-9,
            sum(b - a for a, b in r.online) * 1e-9, r.cpu_ns * 1e-9]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="pitbench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device: Optional[str] = None, root: Path = ROOT,
         t_start: Optional[float] = None) -> int:
    """The command. ``device`` is None for the card (required), or
    ``"cpu"`` where a test drives the rest of a run without one."""
    args = parse(argv)
    if device is None:
        import torch

        spec = load_spec(args.workload, root)
        need = spec["cell"]["chips"]
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            print(f"pitbench: needs {need} CUDA device(s); found {have}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    out = run_cell(args, device=device, root=root, t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"pitbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        lim = c.get("limit")
        print(f"check {name} {c['value']}"
              + (f" limit {lim}" if lim is not None else ""),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
