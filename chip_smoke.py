#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers 1] [--seq 8] [--requests 2]

Phases, each asserting (any failure exits non-zero and prints no result):

1. device   — the card's name and its ``nvidia-smi`` name/power-limit line;
2. build    — ``nvcc`` builds every kernel source of the serving path from
              the checkout (``sm_90a``), all sources at once;
3. kernels  — each kernel's wrapper on CUDA tensors at the serving path's
              shapes (all four ops, a ragged G) against its plain PyTorch
              version on the same inputs: bit-exact; kernel time (device
              time from ``torch.profiler``), the plain version's time and
              the roofline bound;
4. parity   — the GC executor (GeLU netlist, I=64) and a private
              transformer session (d=64, 4 heads, d_ff=128, 1 layer, S=4)
              on ``cuda`` against the same on ``cpu``: bit-exact;
5. serving  — ``PrivateServeEngine`` → ``compile_session`` → ``preprocess``
              → ``serve`` at BERT-base width (d=768, 12 heads, d_ff=3072,
              GeLU, LayerNorm offload, wire v1); depth and sequence length
              are cut only to fit the time limit (``--layers``, ``--seq``).
              The launch counters are zeroed just before and read just
              after; every kernel of the path must have launched.
6. profile  — one more request on the same engine under ``torch.profiler``
              (after the counters are read): device time by kernel and the
              device's busy share of that request's wall time.

The line before the last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``. ``--json PATH`` also writes every
measurement (per-shape kernel times, phase times, span totals) to PATH.
Needs ``torch`` with CUDA and ``nvcc``; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM roofline: HBM3 bandwidth, and int32 rate = 132 SMs x 64 int32
#: lanes per clock x 1.98 GHz boost clock (NVIDIA data sheet and Hopper
#: architecture white paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

DEVICE = "cuda"


def _ms_events(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ms_kernel(fn, name, reps):
    """Device time per launch of the CUDA kernel whose name contains
    ``name``, from ``torch.profiler``; None if the trace has none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except (RuntimeError, AssertionError) as e:  # no CUDA activity traced
        print(f"[kernels] torch.profiler unavailable ({e!r})")
        return None
    for ev in events:
        if name in ev.key and ev.count:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            if us > 0:
                return us / ev.count / 1e3
    return None


def _max_abs_diff(xs, ys):
    return max(int((x.long() - y.long()).abs().max().item()) if x.numel()
               else 0 for x, y in zip(xs, ys))


def _bound_ms(lanes, bytes_per_lane, ops_per_lane):
    t_bytes = lanes * bytes_per_lane / HBM_BYTES_PER_S
    t_ops = lanes * ops_per_lane / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    assert smi.returncode == 0, smi.stderr
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(smi.stdout.strip().splitlines()[0])
    return name, smi.stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.level_eval import level_eval as LE

    t0 = time.perf_counter()
    built = build.build([LE.SOURCE])
    secs = time.perf_counter() - t0
    for b in built:
        regs = [ln.strip() for ln in b.log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {b.source.relative_to(ROOT)}: nvcc {b.seconds:.2f} s"
              f" -> {b.path.name}; " + " | ".join(regs))
    print(f"[build] all kernels in {secs:.2f} s")
    return {"seconds": secs,
            "libraries": {str(b.source.relative_to(ROOT)): b.path.name
                          for b in built}}


def _level_inputs(G, gen, dev):
    import torch

    def words(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                             generator=gen).to(dev)

    ops = torch.arange(G, dtype=torch.int32) % 4
    ops = ops[torch.randperm(G, generator=gen)].to(dev)
    r = words(1, 4)
    r[:, 0] |= 1
    return dict(ops=ops, a=words(G, 4), b=words(G, 4), tg=words(G, 4),
                te=words(G, 4), r=r.expand(G, 4).contiguous(),
                tw=words(G))


def phase_kernels(args):
    import torch
    from repro_torch.kernels.level_eval import level_eval as LE
    from repro_torch.kernels.level_eval import ref

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(args.seed)
    # the serving path's largest chunks: GeLU lanes (and_width 8) over one
    # request's instances (evaluate) and over the preprocessed batch
    # (garble); a LayerNorm-like chunk; a ragged G
    g_eval = 8 * args.seq * args.d_ff
    g_garble = 8 * args.requests * args.seq * args.d_ff
    shapes = sorted({g_eval, g_garble, 512 * 32, 12345})
    rows = {}
    for G in shapes:
        v = _level_inputs(G, gen, dev)
        ev = (v["ops"], v["a"], v["b"], v["tg"], v["te"], v["tw"])
        ga = (v["ops"], v["a"], v["b"], v["r"], v["tw"])
        got = LE.eval_level(*ev)
        want = ref.eval_level(*ev)
        gg = LE.garble_level(*ga)
        gw = ref.garble_level(*ga)
        torch.cuda.synchronize()
        # words are bit patterns: any difference is an error, and the
        # largest difference of the int64-widened words is reported
        err = {"eval_level": _max_abs_diff([got], [want]),
               "garble_level": _max_abs_diff(gg, gw)}
        for kname, e in err.items():
            assert e == 0, f"{kname} kernel != plain version at G={G}: {e}"
        line = {"G": G}
        for kname, fn, plain, kernel_sym, nbytes, nops in (
                ("eval_level", lambda: LE.eval_level(*ev),
                 lambda: ref.eval_level(*ev), "eval_level_kernel",
                 LE.EVAL_BYTES, LE.EVAL_OPS),
                ("garble_level", lambda: LE.garble_level(*ga),
                 lambda: ref.garble_level(*ga), "garble_level_kernel",
                 LE.GARBLE_BYTES, LE.GARBLE_OPS)):
            fn()
            plain()
            torch.cuda.synchronize()
            ms = _ms_kernel(fn, kernel_sym, 20)
            call_ms = _ms_events(fn, 20)
            plain_ms = _ms_events(plain, 5)
            bound, by = _bound_ms(G, nbytes, nops)
            line[kname] = dict(max_abs_err=err[kname],
                               ms=ms if ms is not None else call_ms,
                               timing="profiler" if ms is not None
                               else "events", call_ms=call_ms,
                               plain_ms=plain_ms, bound_ms=bound,
                               bound_by=by)
        rows[G] = line
        print(f"[kernels] G={G}: bit-exact; " + "; ".join(
            f"{k} {line[k]['ms']:.4f} ms (call {line[k]['call_ms']:.4f}, "
            f"plain {line[k]['plain_ms']:.3f}, bound {line[k]['bound_ms']:.4f}"
            f" by {line[k]['bound_by']})"
            for k in ("eval_level", "garble_level")))
    del v, ev, ga, got, want, gg, gw
    torch.cuda.empty_cache()
    return rows, g_eval, g_garble


def phase_parity(args):
    import numpy as np
    import torch
    from repro_torch.config import PrivacyConfig
    from repro_torch.core import garble as G
    from repro_torch.core.engine import PrivateTransformer, random_weights
    from repro_torch.core.protocol import PiTProtocol

    t0 = time.perf_counter()
    net = PiTProtocol(PrivacyConfig(), seed=0, device="cpu") \
        .activation_net("gelu", 24)
    I = 64
    rng = np.random.default_rng(args.seed)
    gb = rng.integers(0, 2, (I, len(net.garbler_inputs)))
    eb = rng.integers(0, 2, (I, len(net.evaluator_inputs)))
    outs = {}
    for dev in (DEVICE, "cpu"):
        gc = G.garble(net, torch.Generator().manual_seed(args.seed), I,
                      device=dev)
        cw, cl = G.const_wires_labels(gc)
        wires = np.concatenate([net.garbler_inputs, net.evaluator_inputs,
                                cw]).astype(np.int64)
        labels = torch.cat([G.encode_inputs(gc, net.garbler_inputs, gb),
                            G.encode_inputs(gc, net.evaluator_inputs, eb),
                            cl], dim=1)
        out = G.evaluate(net, gc.tables, (wires, labels))
        outs[dev] = [x.cpu() for x in (gc.input_zero, gc.tables,
                                       gc.output_perm, out)]
        assert np.array_equal(G.decode_outputs(gc, out),
                              net.eval_plain(gb, eb)), dev
    assert all(torch.equal(x, y) for x, y in zip(outs[DEVICE], outs["cpu"]))
    t_exec = time.perf_counter() - t0
    print(f"[parity] GC executor, GeLU netlist ({net.and_count} AND) at "
          f"I={I}: cuda == cpu bit-exact, outputs == plain eval "
          f"({t_exec:.1f} s)")

    t0 = time.perf_counter()
    d, heads, d_ff, S = 64, 4, 128, 4
    ys = {}
    for dev in (DEVICE, "cpu"):
        ws = random_weights(np.random.default_rng(args.seed), d, d_ff, 1)
        model = PrivateTransformer(PrivacyConfig(frac_bits=6), d, heads,
                                   d_ff, ws, seed=args.seed, device=dev)
        sess = model.compile_session(S)
        bundle = sess.preprocess(1)[0]
        x = np.random.default_rng(args.seed + 1).normal(0, 1, (S, d))
        ys[dev] = (sess.run(x, bundle), model.forward_float(x))
    y, ref = ys[DEVICE]
    assert np.array_equal(y, ys["cpu"][0]), "session: cuda != cpu"
    err = np.abs(y - ref)
    t_sess = time.perf_counter() - t0
    print(f"[parity] session d={d} h={heads} d_ff={d_ff} S={S} (frac 6): "
          f"cuda == cpu bit-exact; |priv - float| max {err.max():.4f} mean "
          f"{err.mean():.4f} ({t_sess:.1f} s)")
    return {"executor_s": t_exec, "session_s": t_sess,
            "session_err_max": float(err.max()),
            "session_err_mean": float(err.mean())}


def phase_serve(args):
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.config import BERT_BASE, PrivacyConfig
    from repro_torch.core.engine import PrivateTransformer, random_weights
    from repro_torch.kernels.level_eval import level_eval as LE
    from repro_torch.serve import PrivateRequest, PrivateServeEngine

    S, d, dff = args.seq, args.d, args.d_ff
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    ws = random_weights(rng, d, dff, args.layers)
    model = PrivateTransformer(PrivacyConfig(), d, args.heads, dff, ws,
                               seed=args.seed, activation=BERT_BASE.activation,
                               device=DEVICE)
    engine = PrivateServeEngine(model, buckets=(S,))
    xs = rng.normal(0, 1, (args.requests, S, d))
    t_setup = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.enable()
    try:
        LE.reset_launches()
        t0 = time.perf_counter()
        engine.preprocess(S, args.requests)
        torch.cuda.synchronize()
        t_off = time.perf_counter() - t0
        # one request at a time: the first also builds the evaluate-side
        # level plans, later ones reuse them
        done, t_req = [], []
        for x in xs:
            t0 = time.perf_counter()
            done += engine.serve([PrivateRequest(x=x)])
            torch.cuda.synchronize()
            t_req.append(time.perf_counter() - t0)
        t_on = sum(t_req)
        launches = {"eval_level": LE.eval_level.launches,
                    "garble_level": LE.garble_level.launches}
    finally:
        obs.disable()
    st = engine.stats(S)
    ys = np.stack([r.result for r in done])
    assert ys.shape == (args.requests, S, d), ys.shape
    assert np.isfinite(ys).all(), "non-finite revealed outputs"
    assert launches["eval_level"] > 0 and launches["garble_level"] > 0, \
        launches
    err = np.abs(ys - np.stack([model.forward_float(x) for x in xs]))
    garbled = st.gc_instances_ands  # metered per op as it is garbled
    evaluated = garbled * len(done) // args.requests
    report = tracer.report()
    spans = {k: v["total_s"] for k, v in report.items()}
    res = {
        "config": dict(d=d, heads=args.heads, d_ff=dff, layers=args.layers,
                       seq=S, requests=args.requests, layernorm_offload=True,
                       wire_version=1, privacy="PrivacyConfig() defaults"),
        "setup_s": t_setup, "offline_s": t_off, "online_s": t_on,
        "online_s_per_request": t_req,
        "offline_mb": st.channel_offline.total / 1e6,
        "online_mb": st.channel_online.total / 1e6,
        "and_gates_garbled": int(garbled),
        "and_gates_evaluated": int(evaluated),
        "per_fn": st.per_fn,
        "err_max": float(err.max()), "err_mean": float(err.mean()),
        "launches": launches,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "spans_s": spans,
    }
    print(f"[serve] BERT-base width d={d} h={args.heads} d_ff={dff}, "
          f"{args.layers} layer(s) of {BERT_BASE.num_layers}, S={S}, "
          f"{args.requests} requests: offline {t_off:.2f} s "
          f"({res['offline_mb']:.1f} MB), online {t_on:.2f} s "
          f"({res['online_mb']:.1f} MB; per request "
          + ", ".join(f"{t:.2f}" for t in t_req)
          + f" s), setup {t_setup:.2f} s")
    print(f"[serve] AND gates garbled {garbled:,} / evaluated {evaluated:,}; "
          f"launches {launches}; peak device memory "
          f"{res['peak_device_gb']:.2f} GB")
    print(f"[serve] |priv - float| max {res['err_max']:.4g} mean "
          f"{res['err_mean']:.4g} (reference tests' bounds at small width: "
          f"max < 0.25, mean < 0.05)")
    top = sorted(spans.items(), key=lambda kv: -kv[1])[:12]
    print("[serve] spans (s): " + "; ".join(f"{k} {v:.2f}" for k, v in top))
    return res, engine, xs[0]


def phase_profile(engine, x, seq):
    """Device time of one warm request, from a CUDA-only profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import PrivateRequest

    engine.preprocess(seq, 1)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.serve([PrivateRequest(x=x)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
    except (RuntimeError, AssertionError) as e:  # no CUDA activity traced
        print(f"[profile] torch.profiler unavailable ({e!r}): not measured")
        return None
    by_kernel = {}
    for ev in events:
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            by_kernel[ev.key] = (us / 1e6, ev.count)
    busy = sum(t for t, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"[profile] one warm request under the profiler: wall {wall:.2f} s,"
          f" device busy {busy:.3f} s ({100 * busy / wall:.2f}%), "
          f"{sum(c for _, c in by_kernel.values()):,} device ops")
    print("[profile] top device time (s, count): " + "; ".join(
        f"{k[:48]} {t:.3f} x{c}" for k, (t, c) in top))
    return {"wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall,
            "top": {k: {"s": t, "count": c} for k, (t, c) in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=1,
                    help="encoder layers (BERT-base has 12)")
    ap.add_argument("--seq", type=int, default=8,
                    help="tokens per request (the paper uses 128)")
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--d-ff", type=int, default=3072)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", type=Path, default=None,
                    help="write all measurements to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_all = time.perf_counter()
    name, smi = phase_device()
    built = phase_build()
    krows, g_eval, g_garble = phase_kernels(args)
    parity = phase_parity(args)
    serve, engine, x0 = phase_serve(args)
    prof = phase_profile(engine, x0, args.seq)

    from repro_torch.kernels.level_eval import level_eval as LE

    src = str(LE.SOURCE.relative_to(ROOT))
    kernels = []
    for kname, G, replaces in (
            ("eval_level", g_eval,
             "src/repro/kernels/level_eval/level_eval.py:59"),
            ("garble_level", g_garble,
             "src/repro/kernels/level_eval/level_eval.py:83")):
        row = krows[G][kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": serve["launches"][kname],
            "max_abs_err": max(r[kname]["max_abs_err"]
                               for r in krows.values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "G": G, "call_ms": row["call_ms"],
            "timing": row["timing"]})
    total = time.perf_counter() - t_all
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "device": name, "nvidia_smi": smi, "build": built,
            "kernels": {str(g): r for g, r in krows.items()},
            "parity": parity, "serve": serve, "profile": prof,
            "total_s": total}, indent=1,
            default=float))
    print(f"[done] {total:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
