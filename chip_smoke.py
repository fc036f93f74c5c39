#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers 1] [--seq 8] [--requests 2]

Phases, each asserting (any failure exits non-zero and prints no result):

1. device   — the card's name and its ``nvidia-smi`` name/power-limit line;
2. build    — ``nvcc`` builds every kernel source of the port from the
              checkout (``sm_90a``), all sources at once: the level and
              walk kernels, the NTT, label select and the Half-Gate gate
              kernels;
3. kernels  — each kernel's wrapper on CUDA tensors at the shapes its path
              gives it, plus a ragged size, against its plain PyTorch
              version on the same inputs: bit-exact; kernel time (device
              time from ``torch.profiler``), the plain version's time and
              the roofline bound; the NTT also at the HE linear's launch
              shapes and at a 31-bit prime, timed warm and L2-cold;
4. parity   — the GC executor (GeLU netlist, I=64) and a private
              transformer session (d=64, 4 heads, d_ff=128, 1 layer, S=4)
              on ``cuda`` against the same on ``cpu``: bit-exact;
5. gates    — the Half-Gate entry points (``garble_and_gates`` →
              ``select_labels`` → ``eval_and_gates``) on G independent AND
              gates, and one padded level of mixed gates through
              ``garble_level`` → ``select_labels`` → ``eval_level``: every
              output decodes to its gate of the inputs; launch counters
              zeroed just before and read just after;
6. he       — ``PiTProtocol(PrivacyConfig(frac_bits=6))`` key generation
              and ``linear_offline(use_he_offline=True)`` at BERT-base
              widths (768→768, 768→3072): the decrypted W·r1 equals the
              exact product mod t and the card equals the CPU, bit for bit;
              seconds of keygen / encrypt / he_matvec / decrypt and NTT
              launches; the same at frac_bits=12, where the count of wrong
              outputs (a fault of the reference protocol) is printed, not
              asserted;
7. serving  — ``PrivateServeEngine`` → ``compile_session`` → ``preprocess``
              → ``serve`` at BERT-base width (d=768, 12 heads, d_ff=3072,
              GeLU, LayerNorm offload, wire v1); depth and sequence length
              are cut only to fit the time limit (``--layers``, ``--seq``).
              The launch counters are zeroed just before the model is built
              (its protocols generate HE keys) and read just after the last
              request; every kernel of the path (the walk kernels, NTT,
              label select) must have launched, the walk kernels once per
              ``gc_exec`` walk, and the per-chunk level kernels not at all;
8. walks    — each walk kernel against its plain walk, bit for bit, on
              every level plan serving compiled (softmax8, trunc, GeLU,
              LayerNorm; both sides), from random stores and tables: the
              kernel's time per walk, µs per chunk, the plain walk's time
              and the roofline bound beside the chain of n_chunks steps;
9. profile  — one more request on the same engine under ``torch.profiler``
              (after the counters are read): device time by kernel and the
              device's busy share of that request's wall time.

The line before the last is the ``kernels`` JSON summary of all eight
kernels; the last line is ``{"ok": true, "device": {...}}``. ``--json
PATH`` also writes every measurement (per-shape kernel times, phase times,
span totals) to PATH. ``--ntt-only`` runs phases 1, 2 and the NTT's part
of 3 and stops (about 20 s), to compare two versions of the NTT in one
call. Needs ``torch`` with CUDA and ``nvcc``; there is no CPU fallback.
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
#: bytes that pass between two uses of a buffer in an L2-cold timing: four
#: times the H100's 50 MB L2
COLD_BYTES = 200e6

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
    print(f"[kernels] no device time for {name!r} in the trace; keys: "
          + "; ".join(ev.key[:60] for ev in events))
    return None


def _max_abs_diff(xs, ys):
    return max(int((x.long() - y.long()).abs().max().item()) if x.numel()
               else 0 for x, y in zip(xs, ys))


def _bound(nbytes, nops):
    """Least time for the work, in ms: bytes over HBM bandwidth or integer
    operations over the int32 rate, whichever is larger, and which."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _bound_ms(lanes, bytes_per_lane, ops_per_lane, extra_bytes=0):
    return _bound(lanes * bytes_per_lane + extra_bytes, lanes * ops_per_lane)


def _timed(fn, plain, kernel_sym, reps=20, plain_reps=5):
    """Kernel time (profiler device time per launch, else CUDA events
    around the call), wrapper-call time and the plain version's time."""
    import torch

    fn()
    plain()
    torch.cuda.synchronize()
    ms = _ms_kernel(fn, kernel_sym, reps)
    if ms is None:  # one more trace before falling back to events
        ms = _ms_kernel(fn, kernel_sym, reps)
    call_ms = _ms_events(fn, reps)
    plain_ms = _ms_events(plain, plain_reps)
    return dict(ms=ms if ms is not None else call_ms,
                timing="profiler" if ms is not None else "events",
                call_ms=call_ms, plain_ms=plain_ms)


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


def _sources():
    from repro_torch.kernels.halfgate import halfgate as HK
    from repro_torch.kernels.label_select import label_select as LS
    from repro_torch.kernels.level_eval import level_eval as LE
    from repro_torch.kernels.ntt import ntt as NTT

    return [LE.SOURCE, NTT.SOURCE, LS.SOURCE, HK.SOURCE]


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build(_sources())
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
            bound, by = _bound_ms(G, nbytes, nops)
            line[kname] = dict(max_abs_err=err[kname],
                               **_timed(fn, plain, kernel_sym),
                               bound_ms=bound, bound_by=by)
        rows[G] = line
        print(f"[kernels] G={G}: bit-exact; " + "; ".join(
            f"{k} {line[k]['ms']:.4f} ms (call {line[k]['call_ms']:.4f}, "
            f"plain {line[k]['plain_ms']:.3f}, bound {line[k]['bound_ms']:.4f}"
            f" by {line[k]['bound_by']})"
            for k in ("eval_level", "garble_level")))
    del v, ev, ga, got, want, gg, gw
    torch.cuda.empty_cache()
    return rows, g_eval, g_garble


def _print_rows(tag, rows):
    for r in rows:
        print(f"[kernels] {tag} {r['shape']}: bit-exact; {r['ms']:.4f} ms "
              f"(call {r['call_ms']:.4f}, plain {r['plain_ms']:.3f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']})")


def _cold_ms(launch_all, launches, kernel_sym, reps=5):
    """Device time per launch when no launch finds its input or output in
    L2: ``launch_all()`` makes ``launches`` launches over distinct inputs
    and keeps their outputs until its next call, so a buffer comes round
    again only after more bytes than the L2 holds have passed (profiler
    device time, else CUDA events)."""
    launch_all()
    ms = _ms_kernel(launch_all, kernel_sym, reps)
    if ms is None:
        ms = _ms_kernel(launch_all, kernel_sym, reps)
    if ms is not None:
        return ms, "profiler"
    return _ms_events(launch_all, reps) / launches, "events"


def phase_kernels_ntt(args):
    """NTT forward and inverse at N=2048, the HE parameters' length.

    Timed at the three HE primes over the rows of a d→d ``he_matvec``
    (P x blocks) and over the launches of ``mul_plain`` in the HE linear at
    d→d and d→d_ff (forward over the ciphertext pair and the plaintexts,
    blocks + 2 rows per prime; inverse over the 2 x blocks products): warm,
    20 launches on one input, and L2-cold, launches rotating over distinct
    inputs and outputs that pass ``COLD_BYTES`` between two uses of a
    buffer. The share of the bound is taken from the cold time. Every
    row count, and a ragged one, is checked bit-exact against the plain
    version in both directions at the HE primes, at a limb prime below
    46340 (the Pallas kernel's range) and at the largest NTT prime below
    2^31."""
    import math

    import torch
    from repro_torch.config import PrivacyConfig
    from repro_torch.core import he as HE
    from repro_torch.kernels.ntt import ntt as NTT
    from repro_torch.kernels.ntt import ref as NR

    pc = PrivacyConfig()
    params = HE.make_params(n=pc.he_poly_n, num_primes=pc.he_num_primes,
                            t_bits=pc.he_t_bits)
    n, qs = params.n, params.qs
    P = len(qs)
    limb = NR.find_ntt_primes(16, 1, n, max_q=NR.INT32_PRODUCT_BOUND)[0]
    q31 = NR.find_ntt_primes(31, 1, n)[0]
    _, b_dd = HE.matvec_plan(params, args.d, args.d)
    _, b_ff = HE.matvec_plan(params, args.d, args.d_ff)
    dd, dff = f"{args.d}->{args.d}", f"{args.d}->{args.d_ff}"
    # (what, rows per prime, inverse)
    timed = [(f"{dd} he_matvec rows", b_dd, False),
             (f"{dd} he_matvec rows", b_dd, True),
             (f"{dd} mul_plain", b_dd + 2, False),
             (f"{dd} mul_plain", 2 * b_dd, True),
             (f"{dff} mul_plain", b_ff + 2, False),
             (f"{dff} mul_plain", 2 * b_ff, True)]
    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)

    def residues(q, per):
        """(P, per, n) at the HE primes; (P * per, n) at one prime."""
        ps = NR.primes_of(q)
        if len(ps) == 1:
            return torch.randint(0, ps[0], (P * per, n), generator=gen,
                                 device=DEVICE)
        return torch.stack([torch.randint(0, p, (per, n), generator=gen,
                                          device=DEVICE) for p in ps])

    def pair(inverse):
        return ((NTT.ntt_inverse, NR.ntt_inverse) if inverse
                else (NTT.ntt_forward, NR.ntt_forward))

    err, checked = 0, []
    for per in sorted({per for _, per, _ in timed} | {37}):
        for q in (qs, limb, q31):
            x = residues(q, per)
            for inverse in (False, True):
                kern, plain = pair(inverse)
                got, want = kern(x, q), plain(x, q)
                torch.cuda.synchronize()
                e = _max_abs_diff([got], [want])
                assert e == 0, (f"ntt (inverse={inverse}) != plain at "
                                f"q={q}, {per} rows per prime: {e}")
                err = max(err, e)
            checked.append((P * per, "HE" if q is qs else q))
            del x, got, want
    print(f"[kernels] ntt bit-exact, forward and inverse, at "
          f"{len(checked)} (rows, primes): " + ", ".join(
              f"{r} x {q}" for r, q in checked))

    rows = []
    for what, per, inverse in timed:
        kern, plain = pair(inverse)
        nrows = P * per
        moved = 2 * nrows * n * 8  # int64 residues in and out
        k = max(2, math.ceil(COLD_BYTES / moved))
        xs = [residues(qs, per) for _ in range(k)]
        x = xs[0]
        warm = _timed(lambda: kern(x, qs), lambda: plain(x, qs),
                      "ntt_kernel")
        outs = []

        def launch_all():
            nonlocal outs
            outs = [kern(xi, qs) for xi in xs]

        cold, cold_timing = _cold_ms(launch_all, k, "ntt_kernel")
        ops = nrows * (n // 2 * (n.bit_length() - 1) * NTT.OPS_PER_BUTTERFLY
                       + (n // 2 * NTT.OPS_PER_SCALE if inverse else 0))
        # residues in and out, the (P, n) int32 psi table, (P, 3) constants
        bound, by = _bound(nrows * n * NTT.BYTES_PER_COEFF + P * n * 4
                           + P * 24, ops)
        rows.append(dict(
            shape=f"{'inverse' if inverse else 'forward'} {what}: P={P} x "
                  f"{per} rows, N={n}",
            what=what, inverse=inverse, P=P, rows=nrows, n=n,
            ms=cold, timing=cold_timing, cold_buffers=k,
            ms_warm=warm["ms"], timing_warm=warm["timing"],
            call_ms=warm["call_ms"], plain_ms=warm["plain_ms"],
            bound_ms=bound, bound_by=by, bound_share=bound / cold, ops=ops))
        del xs, x, outs
        torch.cuda.empty_cache()
    for r in rows:
        print(f"[kernels] ntt {r['shape']}: cold {r['ms']:.4f} ms "
              f"({r['timing']}, {r['cold_buffers']} buffers), warm "
              f"{r['ms_warm']:.4f} ms ({r['timing_warm']}; call "
              f"{r['call_ms']:.4f}), plain {r['plain_ms']:.3f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']} "
              f"({100 * r['bound_share']:.0f}% of it when cold)")
    print(f"[kernels] ntt bound: {NTT.BYTES_PER_COEFF} B per coefficient "
          f"(int64 in and out) plus the int32 psi table; "
          f"{NTT.OPS_PER_BUTTERFLY} int32 operations per butterfly "
          f"(+{NTT.OPS_PER_SCALE} per butterfly of the inverse's last stage "
          "for the n^-1 scale)")
    return rows, err


def phase_kernels_gates(args, gates):
    """Half-Gate garble / eval of independent AND gates (the Pallas
    kernels' operands) at G gates and a ragged G; label select at the
    serving path's OT and input-encoding shapes (R shared per instance)
    and a ragged shape."""
    import torch
    from repro_torch.config import PrivacyConfig
    from repro_torch.core import he as HE
    from repro_torch.core.circuits.shares import gc_word_bits
    from repro_torch.kernels.halfgate import halfgate as HK
    from repro_torch.kernels.halfgate import ref as HR
    from repro_torch.kernels.label_select import label_select as LS
    from repro_torch.kernels.label_select import ref as LR

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(args.seed + 1)
    hg, err = [], {"garble_and": 0, "eval_and": 0, "select_labels": 0}
    for G in (gates, 12345):
        v = _level_inputs(G, gen, dev)
        ga = (v["a"], v["b"], v["r"], v["tw"])
        ev = (v["a"], v["b"], v["tg"], v["te"], v["tw"])
        e1 = _max_abs_diff(HK.garble_gates(*ga), HR.garble_and_gates(*ga))
        e2 = _max_abs_diff([HK.eval_gates(*ev)], [HR.eval_and_gates(*ev)])
        torch.cuda.synchronize()
        assert e1 == 0 and e2 == 0, f"Half-Gate kernels != plain at G={G}"
        err["garble_and"] = max(err["garble_and"], e1)
        err["eval_and"] = max(err["eval_and"], e2)
        if G != gates:
            continue
        for name, fn, plain, sym, nb, no in (
                ("garble_and", lambda: HK.garble_gates(*ga),
                 lambda: HR.garble_and_gates(*ga), "garble_and_kernel",
                 HK.GARBLE_BYTES, HK.GARBLE_OPS),
                ("eval_and", lambda: HK.eval_gates(*ev),
                 lambda: HR.eval_and_gates(*ev), "eval_and_kernel",
                 HK.EVAL_BYTES, HK.EVAL_OPS)):
            bound, by = _bound_ms(G, nb, no)
            hg.append(dict(name=name, shape=f"{name} G={G}", G=G,
                           **_timed(fn, plain, sym), bound_ms=bound,
                           bound_by=by))
    _print_rows("halfgate", hg)

    pc = PrivacyConfig()
    k = gc_word_bits(HE.make_params(n=pc.he_poly_n,
                                    num_primes=pc.he_num_primes,
                                    t_bits=pc.he_t_bits).t)
    inst = args.seq * args.d_ff  # GeLU instances of one request
    ls = []
    for lead, main in (((inst, 2 * k), True), ((inst, k), True),
                       ((37, 41), False)):
        w0 = torch.randint(-(1 << 31), 1 << 31, (*lead, 4), dtype=torch.int32,
                           generator=gen).to(dev)
        r = torch.randint(-(1 << 31), 1 << 31, (lead[0], 1, 4),
                          dtype=torch.int32, generator=gen).to(dev)
        bits = torch.randint(0, 2, lead, dtype=torch.int32,
                             generator=gen).to(dev)
        e = _max_abs_diff([LS.select_labels(w0, r, bits)],
                          [LR.select_labels(w0, r, bits)])
        torch.cuda.synchronize()
        assert e == 0, f"select_labels != plain at {lead}"
        err["select_labels"] = max(err["select_labels"], e)
        if not main:
            continue
        G = lead[0] * lead[1]
        bound, by = _bound_ms(G, LS.BYTES_PER_ROW, LS.OPS_PER_ROW,
                              extra_bytes=lead[0] * 16)
        ls.append(dict(name="select_labels",
                       shape=f"select_labels I={lead[0]} x {lead[1]} wires",
                       G=G, **_timed(lambda: LS.select_labels(w0, r, bits),
                                     lambda: LR.select_labels(w0, r, bits),
                                     "select_labels_kernel"),
                       bound_ms=bound, bound_by=by))
    _print_rows("label_select", ls)
    return hg, ls, err


def phase_gates(args, gates):
    """The Half-Gate entry points end to end on independent AND gates:
    garble, choose active labels, evaluate, decode."""
    import torch
    from repro_torch.kernels import halfgate as HP
    from repro_torch.kernels.halfgate import halfgate as HK
    from repro_torch.kernels.label_select import label_select as LS
    from repro_torch.kernels.label_select import select_labels
    from repro_torch.kernels.level_eval import level_eval as LE

    gen = torch.Generator().manual_seed(args.seed + 2)
    words = lambda *s: torch.randint(  # noqa: E731
        -(1 << 31), 1 << 31, s, dtype=torch.int32, generator=gen)
    a0, b0, r = words(gates, 4), words(gates, 4), words(1, 4)
    r[:, 0] |= 1
    tw = torch.arange(gates, dtype=torch.int32)
    abits = torch.randint(0, 2, (gates,), generator=gen)
    bbits = torch.randint(0, 2, (gates,), generator=gen)
    # one padded level: XOR, AND, INV and PAD lanes (ops 0..3)
    ops = torch.randint(0, 4, (gates,), generator=gen, dtype=torch.int32)
    a0, b0, r, tw, abits, bbits, ops = (x.to(DEVICE) for x in
                                        (a0, b0, r, tw, abits, bbits, ops))
    r_g = r.expand(gates, 4).contiguous()
    HK.reset_launches()
    LS.reset_launches()
    LE.reset_launches()
    t0 = time.perf_counter()
    c0, tg, te = HP.garble_and_gates(a0, b0, r, tw)
    a = select_labels(a0, r, abits)
    b = select_labels(b0, r, bbits)
    c = HP.eval_and_gates(a, b, tg, te, tw)
    l0, ltg, lte = LE.garble_level(ops, a0, b0, r_g, tw)
    lc = LE.eval_level(ops, a, b, ltg, lte, tw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"garble_and": HK.garble_gates.launches,
                "eval_and": HK.eval_gates.launches,
                "select_labels": LS.select_labels.launches,
                "garble_level": LE.garble_level.launches,
                "eval_level": LE.eval_level.launches}
    # the output label encodes a AND b: c == c0 ^ (R if a & b)
    want = c0 ^ (r & -(abits & bbits).to(torch.int32)[:, None])
    assert torch.equal(c, want), "Half-Gate outputs do not decode to a & b"
    # a level's output label encodes op(a, b): XOR, AND, NOT a, and 0 on
    # pads (whose labels are zero on both sides)
    bit = torch.where(ops == 0, abits ^ bbits, torch.where(
        ops == 1, abits & bbits, torch.where(ops == 2, 1 - abits,
                                             torch.zeros_like(abits))))
    want = l0 ^ (r & -bit.to(torch.int32)[:, None])
    assert torch.equal(lc, want), "level outputs do not decode to op(a, b)"
    assert all(v > 0 for v in launches.values()), launches
    print(f"[gates] {gates:,} AND gates garbled, labels chosen, evaluated "
          f"and decoded to a & b through the entry points, and a level of "
          f"{gates:,} mixed gates to op(a, b) ({secs:.3f} s); "
          f"launches {launches}")
    return {"G": gates, "seconds": secs, "launches": launches}


def phase_he(args):
    """HE on the card at BERT-base widths; card == CPU, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.config import PrivacyConfig
    from repro_torch.core import he as HE
    from repro_torch.core import secret_sharing as SS
    from repro_torch.core.protocol import PiTProtocol
    from repro_torch.kernels.ntt import ntt as NTT

    def launches():
        return NTT.ntt_forward.launches + NTT.ntt_inverse.launches

    rng = np.random.default_rng(args.seed)
    shapes = [(args.d, args.d), (args.d_ff, args.d)]  # (d_out, d_in)
    Ws = {sh: rng.normal(0, 0.05, sh) for sh in shapes}
    res = {"launches": {}, "wrong": {}, "seconds": {}}
    for frac in (6, 12):
        runs = {}
        for dev in ((DEVICE, "cpu") if frac == 6 else (DEVICE,)):
            NTT.reset_launches()
            t0 = time.perf_counter()
            p = PiTProtocol(PrivacyConfig(frac_bits=frac), seed=args.seed,
                            device=dev)
            if dev == DEVICE:
                torch.cuda.synchronize()
            out = {"init_s": time.perf_counter() - t0,
                   "init_launches": launches(),
                   "keys": [x.cpu() for x in (p.sk, *p.pk)]}
            for sh in shapes:
                NTT.reset_launches()
                t0 = time.perf_counter()
                corr = p.linear_offline(Ws[sh], (sh[1],), use_he_offline=True)
                if dev == DEVICE:
                    torch.cuda.synchronize()
                wr = SS.add_mod(corr.client_y, corr.s_mask, p.t)
                exact = SS.matmul_mod(corr.Wmod, corr.r1.reshape(-1, 1),
                                      p.t).reshape(-1)
                out[sh] = dict(seconds=time.perf_counter() - t0,
                               launches=launches(), client_y=corr.client_y,
                               wrong=int((wr != exact).sum()))
            runs[dev] = out
        card = runs[DEVICE]
        tag = f"frac={frac}"
        res["launches"][tag] = {"init": card["init_launches"], **{
            f"{sh[1]}->{sh[0]}": card[sh]["launches"] for sh in shapes}}
        res["wrong"][tag] = {f"{sh[1]}->{sh[0]}": card[sh]["wrong"]
                             for sh in shapes}
        res["seconds"][tag] = {"init": card["init_s"], **{
            f"{sh[1]}->{sh[0]}": card[sh]["seconds"] for sh in shapes}}
        assert card["init_launches"] > 0, "no NTT launch at protocol init"
        if frac == 6:
            cpu = runs["cpu"]
            assert all(torch.equal(x, y) for x, y in
                       zip(card["keys"], cpu["keys"])), "keys: cuda != cpu"
            for sh in shapes:
                assert card[sh]["wrong"] == 0, \
                    f"HE linear {sh[1]}->{sh[0]} at frac 6 is not exact"
                assert np.array_equal(card[sh]["client_y"],
                                      cpu[sh]["client_y"]), \
                    f"HE linear {sh[1]}->{sh[0]}: cuda != cpu"
                assert card[sh]["launches"] > 0
            res["seconds"]["cpu frac=6"] = {f"{sh[1]}->{sh[0]}":
                                            cpu[sh]["seconds"]
                                            for sh in shapes}
            print(f"[he] frac 6: decrypted W·r1 == exact product mod t at "
                  + ", ".join(f"{sh[1]}->{sh[0]}" for sh in shapes)
                  + "; cuda == cpu bit-exact (keys and shares)")
        print(f"[he] {tag}: protocol init {card['init_s']:.3f} s "
              f"({card['init_launches']} NTT launches); linear_offline "
              + "; ".join(f"{sh[1]}->{sh[0]} {card[sh]['seconds']:.3f} s, "
                          f"{card[sh]['launches']} NTT launches, "
                          f"{card[sh]['wrong']} of {sh[0]} outputs wrong"
                          for sh in shapes))

    # the steps one by one on the card, each ending in a synchronize;
    # second of two repetitions (the first builds the NTT tables)
    p = PiTProtocol(PrivacyConfig(frac_bits=6), seed=args.seed,
                    device=DEVICE)
    params = p.params
    gen = torch.Generator().manual_seed(args.seed)
    steps = {}

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for sh in shapes:
        d_out, d_in = sh
        Wq, _ = p.quantize_weight(Ws[sh])
        r1 = rng.integers(0, params.t, d_in, dtype=np.uint64)
        for _ in range(2):
            (sk, pk), t_key = clock(lambda: HE.keygen(params, gen, DEVICE))
            ct, t_enc = clock(lambda: HE.encrypt(
                params, pk, HE.encode_coeffs(params, r1, DEVICE), gen))
            outs, t_mv = clock(lambda: HE.he_matvec(params, ct, Wq))
            _, t_dec = clock(lambda: HE.decrypt(
                params, sk, outs, coeffs=HE.matvec_coeffs(params, d_in,
                                                          d_out)))
        steps[f"{d_in}->{d_out}"] = dict(
            keygen_s=t_key, encrypt_s=t_enc, he_matvec_s=t_mv,
            decrypt_s=t_dec, ciphertexts=int(outs[0].shape[1]))
        print(f"[he] {d_in}->{d_out} on the card (warm): keygen {t_key:.4f} s,"
              f" encrypt {t_enc:.4f} s, he_matvec {t_mv:.4f} s "
              f"({outs[0].shape[1]} ciphertexts), decrypt {t_dec:.4f} s")
    res["steps"] = steps
    return res


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
    from repro_torch.kernels.label_select import label_select as LS
    from repro_torch.kernels.level_eval import level_eval as LE
    from repro_torch.kernels.ntt import ntt as NTT
    from repro_torch.serve import PrivateRequest, PrivateServeEngine

    S, d, dff = args.seq, args.d, args.d_ff
    rng = np.random.default_rng(args.seed)
    ws = random_weights(rng, d, dff, args.layers)
    xs = rng.normal(0, 1, (args.requests, S, d))
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.enable()
    try:
        # zeroed before the model is built: its protocols (model and
        # session) generate their HE keys through the NTT kernel
        for mod in (LE, NTT, LS):
            mod.reset_launches()
        t0 = time.perf_counter()
        model = PrivateTransformer(PrivacyConfig(), d, args.heads, dff, ws,
                                   seed=args.seed,
                                   activation=BERT_BASE.activation,
                                   device=DEVICE)
        engine = PrivateServeEngine(model, buckets=(S,))
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
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
        launches = {"eval_walk": LE.eval_walk.launches,
                    "garble_walk": LE.garble_walk.launches,
                    "ntt": NTT.ntt_forward.launches
                    + NTT.ntt_inverse.launches,
                    "select_labels": LS.select_labels.launches}
        chunk_launches = {"eval_level": LE.eval_level.launches,
                          "garble_level": LE.garble_level.launches}
    finally:
        obs.disable()
    st = engine.stats(S)
    ys = np.stack([r.result for r in done])
    assert ys.shape == (args.requests, S, d), ys.shape
    assert np.isfinite(ys).all(), "non-finite revealed outputs"
    assert all(v > 0 for v in launches.values()), launches
    report = tracer.report()
    walks = {side: sum(v["count"] for k, v in report.items()
                       if k.split("/")[-1] == f"gc_exec.{side}")
             for side in ("evaluate", "garble")}
    # one walk kernel launch per executor walk, no per-chunk kernel
    assert (launches["eval_walk"], launches["garble_walk"]) == \
        (walks["evaluate"], walks["garble"]), (launches, walks)
    assert not any(chunk_launches.values()), chunk_launches
    err = np.abs(ys - np.stack([model.forward_float(x) for x in xs]))
    garbled = st.gc_instances_ands  # metered per op as it is garbled
    evaluated = garbled * len(done) // args.requests
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
        "launches": launches, "walks": walks,
        "level_launches": chunk_launches,
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
          f"launches {launches} ({walks['evaluate']} evaluate and "
          f"{walks['garble']} garble walks; per-chunk level kernels "
          f"{chunk_launches}); peak device memory "
          f"{res['peak_device_gb']:.2f} GB")
    print(f"[serve] |priv - float| max {res['err_max']:.4g} mean "
          f"{res['err_mean']:.4g} (reference tests' bounds at small width: "
          f"max < 0.25, mean < 0.05)")
    top = sorted(spans.items(), key=lambda kv: -kv[1])[:12]
    print("[serve] spans (s): " + "; ".join(f"{k} {v:.2f}" for k, v in top))
    return res, engine, xs[0]


def _serving_executors(engine):
    """Every level executor that serving built on the card, from the
    sessions' protocols' netlist caches (plans hang off the netlists;
    executors are keyed by device string, ``cuda`` or ``cuda:0``)."""
    import torch

    seen = {}
    for sess in engine._sessions.values():
        for net in sess.protocol._netlist_cache.values():
            for plan in getattr(net, "_level_plans", {}).values():
                for exe in plan._executors.values():
                    if exe.device.type == torch.device(DEVICE).type:
                        seen[id(exe)] = exe
    return list(seen.values())


def _walk_bound(exe, garble):
    """Least time of one walk: its records, source labels, tables (read on
    evaluate, written on garble), R and output labels, each moved once,
    against its Half-Gates (``EVAL_OPS`` / ``GARBLE_OPS`` per real AND
    gate and instance)."""
    from repro_torch.kernels.level_eval import level_eval as LE

    plan, I = exe.plan, exe.instances
    meta = exe._garble_meta if garble else exe._eval_meta
    nbytes = (meta.records.numel() * 4 + len(plan.source_ids) * I * 16
              + plan.n_and * I * 32 + len(plan.out_rows) * I * 16
              + (I * 16 if garble else 0))
    nops = plan.n_and * I * (LE.GARBLE_OPS if garble else LE.EVAL_OPS)
    return _bound(nbytes, nops)


def phase_walks(engine, args):
    """Each walk kernel against its plain walk on the plans serving
    compiled, bit for bit, from a random store (R row set on garble) and
    random tables; kernel and plain times per walk, by CUDA events (a
    walk is one launch of milliseconds: the events' overhead is
    microseconds). The plain walk is timed on its one run, the one
    compared."""
    import torch
    from repro_torch.kernels.level_eval import level_eval as LE
    from repro_torch.kernels.level_eval import ref

    gen = torch.Generator().manual_seed(args.seed + 3)
    rows = []
    for exe in sorted(_serving_executors(engine),
                      key=lambda e: (e.plan._net.name, e.instances)):
        plan, I = exe.plan, exe.instances
        for garble in (False, True):
            if not (exe.n_garble_calls if garble else exe.n_eval_calls):
                continue
            meta = exe._garble_meta if garble else exe._eval_meta

            def words(*shape):
                return torch.randint(-(1 << 31), 1 << 31, shape,
                                     dtype=torch.int32, generator=gen
                                     ).to(DEVICE)

            store = words(meta.store_rows, I, 4)
            r = words(I, 4)
            r[:, 0] |= 1
            store[-1] = r
            tabs = [words(meta.table_rows, I, 4) for _ in range(2)]
            # the kernel walks copies; the plain walk the originals
            out = [store.clone(), *(t.clone() for t in tabs)]
            if garble:
                def kern():
                    LE.garble_walk(meta, out[0], r, *out[1:])

                def plain():
                    ref.garble_walk(meta, store, r, *tabs)
            else:
                def kern():
                    LE.eval_walk(meta, *out)

                def plain():
                    ref.eval_walk(meta, store, *tabs)
            kern()
            plain_ms = _ms_events(plain, 1)
            e = _max_abs_diff(out, [store, *tabs])
            assert e == 0, (f"{'garble' if garble else 'eval'}_walk != plain"
                            f" walk on {plan._net.name} I={I}: {e}")
            name = "garble_walk" if garble else "eval_walk"
            ms = _ms_events(kern, 3)
            t = dict(ms=ms, timing="events", call_ms=ms, plain_ms=plain_ms)
            bound, by = _walk_bound(exe, garble)
            shape = LE.walk_shape(meta.and_width, meta.free_width,
                                  meta.stride, I)
            rows.append(dict(
                name=name, netlist=plan._net.name, instances=I,
                widths=[plan.and_width, plan.free_width],
                chunks=plan.n_chunks, and_gates=plan.n_and,
                walks_per_run=(exe.n_garble_calls if garble
                               else exe.n_eval_calls),
                tile=shape.tile, cluster=shape.cluster, max_abs_err=e,
                **t, us_per_chunk=1e3 * t["ms"] / plan.n_chunks,
                bound_ms=bound, bound_by=by))
            del store, tabs, out
            torch.cuda.empty_cache()
    for r in rows:
        print(f"[walks] {r['name']} {r['netlist']} I={r['instances']} "
              f"({r['chunks']} chunks of {r['widths']}, tile {r['tile']} x "
              f"cluster {r['cluster']}): bit-exact; {r['ms']:.3f} ms "
              f"({r['us_per_chunk']:.2f} us/chunk; plain {r['plain_ms']:.1f}"
              f" ms; bound {r['bound_ms']:.4f} ms by {r['bound_by']}; "
              f"{r['walks_per_run']} walks in serving)")
    assert {r["name"] for r in rows} == {"eval_walk", "garble_walk"}, rows
    return rows


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
    ap.add_argument("--ntt-only", action="store_true",
                    help="run the device, build and NTT kernel phases only "
                         "(to compare two versions of the NTT in one call);"
                         " prints no kernels or ok line")
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
    if args.ntt_only:
        ntt_rows, ntt_err = phase_kernels_ntt(args)
        if args.json is not None:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps({
                "device": name, "nvidia_smi": smi, "build": built,
                "ntt": ntt_rows, "max_abs_err": ntt_err,
                "total_s": time.perf_counter() - t_all}, indent=1,
                default=float))
        print(f"[done] {time.perf_counter() - t_all:.1f} s")
        return 0
    krows, g_eval, g_garble = phase_kernels(args)
    ntt_rows, ntt_err = phase_kernels_ntt(args)
    hg_rows, ls_rows, gate_err = phase_kernels_gates(args, g_eval)
    parity = phase_parity(args)
    gates = phase_gates(args, g_eval)
    he = phase_he(args)
    serve, engine, x0 = phase_serve(args)
    walks = phase_walks(engine, args)
    prof = phase_profile(engine, x0, args.seq)

    src = {Path(p).parent.parent.name: str(Path(p).relative_to(ROOT))
           for p in _sources()}
    kernels = []
    for kname, G, replaces in (
            ("eval_level", g_eval,
             "src/repro/kernels/level_eval/level_eval.py:59"),
            ("garble_level", g_garble,
             "src/repro/kernels/level_eval/level_eval.py:83")):
        row = krows[G][kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src["level_eval"],
            "replaces": replaces, "launches": gates["launches"][kname],
            "launches_from": "gates",
            "launches_serving": serve["level_launches"][kname],
            "max_abs_err": max(r[kname]["max_abs_err"]
                               for r in krows.values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "G": G, "call_ms": row["call_ms"],
            "timing": row["timing"]})
    # the walk kernels: the serving walk with the most chunks, per side
    # (softmax8), beside every serving walk under "walks"
    for kname, replaces in (
            ("eval_walk", "src/repro/kernels/level_eval/level_eval.py:59"),
            ("garble_walk", "src/repro/kernels/level_eval/level_eval.py:83")):
        mine = [r for r in walks if r["name"] == kname]
        row = max(mine, key=lambda r: r["chunks"])
        kernels.append({
            "name": kname, "route": "cuda", "source": src["level_eval"],
            "replaces": replaces, "launches": serve["launches"][kname],
            "launches_from": "serving",
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "netlist": row["netlist"],
            "instances": row["instances"], "chunks": row["chunks"],
            "us_per_chunk": row["us_per_chunk"], "call_ms": row["call_ms"],
            "timing": row["timing"],
            "walks": [{k: r[k] for k in ("netlist", "instances", "chunks",
                                         "ms", "us_per_chunk", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "walks_per_run")} for r in mine]})
    # the HE primes at the d->d he_matvec rows, L2-cold; every shape,
    # warm and cold, under "shapes"
    fwd, inv = ntt_rows[0], ntt_rows[1]
    kernels.append({
        "name": "ntt", "route": "cuda", "source": src["ntt"],
        "replaces": "src/repro/kernels/ntt/ntt.py:89",
        "launches": serve["launches"]["ntt"], "max_abs_err": ntt_err,
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": None, "rows": fwd["rows"], "n": fwd["n"],
        "call_ms": fwd["call_ms"], "timing": fwd["timing"],
        "ms_warm": fwd["ms_warm"],
        "inverse_ms": inv["ms"], "inverse_ms_warm": inv["ms_warm"],
        "inverse_plain_ms": inv["plain_ms"],
        "inverse_bound_ms": inv["bound_ms"],
        "launches_he_phase": he["launches"],
        "shapes": [{k: r[k] for k in ("shape", "rows", "ms", "ms_warm",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "timing", "timing_warm")}
                   for r in ntt_rows]})
    for row, replaces in ((hg_rows[0], "src/repro/kernels/halfgate/"
                           "halfgate.py:64"),
                          (hg_rows[1], "src/repro/kernels/halfgate/"
                           "halfgate.py:95"),
                          (ls_rows[0], "src/repro/kernels/label_select/"
                           "label_select.py:37")):
        kname = row["name"]
        on_path = kname == "select_labels"
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src["label_select" if on_path else "halfgate"],
            "replaces": replaces,
            "launches": (serve["launches"] if on_path
                         else gates["launches"])[kname],
            "launches_from": "serving" if on_path else "gates",
            "max_abs_err": gate_err[kname],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "G": row["G"], "call_ms": row["call_ms"],
            "timing": row["timing"]})
    total = time.perf_counter() - t_all
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "device": name, "nvidia_smi": smi, "build": built,
            "kernels": {str(g): r for g, r in krows.items()},
            "ntt": ntt_rows, "halfgate": hg_rows, "label_select": ls_rows,
            "parity": parity, "gates": gates,
            "he": he, "serve": serve, "walks": walks,
            "profile": prof, "total_s": total}, indent=1,
            default=float))
    print(f"[done] {total:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
