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
              time from ``torch.profiler``) L2-cold (launches rotating over
              input and output buffers that pass ``COLD_BYTES`` between two
              uses) and warm (20 launches on one input), the plain
              version's time and the roofline bound; the NTT also at the
              HE linear's launch shapes and at a 31-bit prime;
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
              device's busy share of that request's wall time;
10. net     — the two-party runtime on the card at the serving phase's
              model and inputs: ``PitNetServer`` + ``GarblerEndpoint`` over
              ``InProcPipe`` (wire v2, IKNP) and over loopback TCP (wire
              v1), ``preprocess(requests)`` and ``requests`` runs each;
              outputs and per-tag ledgers (both endpoints) equal to the
              in-process session at the same wire version (the v2 check
              session, untimed, takes the v2 endpoints' plans instead of
              building its own); counters zeroed
              before the endpoints are built, and the walk kernels, label
              select and the NTT must have launched; offline and online
              seconds, MB per tag, device-to-host and host-to-device copy
              seconds (spans ``net.d2h`` / ``net.h2d``) and the busy share
              of a warm run;
11. gateway — ``PitGateway`` on one loopback ``TcpListener`` over the
              ``net`` phase's v1 server state, at the same model and
              inputs: a ``gateway_client`` and a ``ResilientClient`` (its
              online leg reset mid-run: burn, resume, fresh bundle) run
              concurrently, a third client and a prep past the pool cap
              are shed with retry-after hints; outputs equal the serving
              phase's, ledgers per session, one garbling slab per
              netlist, the burn/resume accounting identity; the walk
              kernels, label select and the NTT launched, no per-chunk
              level kernel (see ``phase_gateway``);
12. eager   — ``forward_private`` on the card at the serving phase's
              model (BERT-base width, same weights, seed and first input),
              equal to that phase's first output bit for bit; the walk
              kernels, label select and the NTT must have launched;
13. model   — the model plane's serving half (torch ops, mostly cuBLAS
              products; no kernel of this repository): ``llama3.2-1b`` at
              full width and depth in bf16 served by ``ServeEngine``
              (two batches of 4 requests, 128-token prompts, 32 new tokens;
              prefill ms, decode ms per step, tokens/s, peak memory, the
              device's busy share of a short generate); the same width at 2
              layers in f32, card == CPU and decode == prefill over the
              grown prompt; ``bert-base-pit`` at full width and depth, and
              at 2 layers card == CPU; every other registered architecture
              reduced, prefill and one decode step card == CPU (see
              ``phase_model``);
14. train   — training on one card (torch ops and autograd; no kernel of
              this repository): ``llama3.2-1b`` at full width and depth
              trained by ``Trainer`` (bf16 compute, f32 master params and
              Adam moments, block remat), 8 sequences of 4,096 tokens as 8
              microbatches, 3 steps (seconds, loss, grad norm, tokens/s,
              peak memory, the model-FLOP share, the device's busy share of
              one profiled step); the same width at 2 layers in f32, one
              step card == CPU; resume bit for bit on the card in a child
              process with deterministic algorithms; every other
              architecture reduced, one step card == CPU and block remat on
              == off (see ``phase_train``);
15. mesh    — the multi-rank plane (DTensor layouts and collectives over
              ``torch.distributed``; no kernel of this repository): four
              ranks on the one card over ``gloo-staged``, started by
              ``torch.distributed.run`` as ``--mesh-child`` processes (a
              failing rank fails the phase): (a) ``olmoe-1b-7b`` at full
              width and depth served on (data=1, model=4), expert
              parallel, params drawn as each rank's blocks; (b) every
              registered architecture reduced, 4 ranks == 1 rank; (c)
              ``llama3.2-1b`` at full width and depth trained by
              ``Trainer(mesh=)`` on (2, 2) (4 x 1,024 tokens), its first
              loss == one rank's
              (run here after the ranks exit); (d) the int8 ring on the
              card == the CPU's, bit for bit; (e) sharded checkpoints
              across 4 ranks and 1, bit for bit (see ``phase_mesh``);
16. smokes  — the port's CI smokes, each a subprocess with its own time
              limit: ``scripts/trace_check.py`` on the ``net`` phase's
              trace; ``scripts/net_smoke_torch.py --trace`` on the card and
              ``trace_check.py`` on its trace; ``scripts/chaos_smoke_torch.py``
              (4 seeded fault schedules over a TCP gateway);
              ``scripts/smoke_models_torch.py`` (every reduced
              architecture); ``scripts/lint_torch.py --all`` (see
              ``phase_smokes``).

Phase 3 also runs the NTT at N = 16384 and 32768 (bit-exact at their HE
primes, a 31-bit prime and ragged rows; profiler times, warm and cold, at
the launch shapes of that ring's HE linear) and
``PiTProtocol(PrivacyConfig(he_poly_n=16384))`` key generation on the card
(keys equal to the CPU's).

The line before the last is the ``kernels`` JSON summary of all eight
kernels (``launches`` from serving, or from ``gates`` off that path, and
``launches_net`` / ``launches_gateway`` / ``launches_eager`` from phases
10 to 12); the last line is ``{"ok": true, "device": {...}}``. ``--json
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
#: the serving path's kernels, and the per-level kernels it must not launch
PATH_KERNELS = ("garble_walk", "eval_walk", "select_labels", "ntt")
LEVEL_KERNELS = ("eval_level", "garble_level")


def _launches(names):
    """The launch counts of the kernels in ``names``, as
    ``repro_torch.kernels.launch_counts`` names them."""
    from repro_torch.kernels import launch_counts

    got = launch_counts()
    return {k: got[k] for k in names}


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
    ``name``, from ``torch.profiler``; None if the trace has none. With a
    tuple of names (a call that launches one of each), the sum of their
    times per launch."""
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
    total = 0.0
    for one in (name if isinstance(name, tuple) else (name,)):
        for ev in events:
            if one in ev.key and ev.count:
                us = getattr(ev, "device_time_total", None)
                if us is None:
                    us = ev.cuda_time_total
                if us > 0:
                    total += us / ev.count / 1e3
                    break
        else:
            print(f"[kernels] no device time for {one!r} in the trace; keys: "
                  + "; ".join(ev.key[:60] for ev in events))
            return None
    return total


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
    dgen = torch.Generator(device=DEVICE).manual_seed(args.seed)
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

        def cold_level(garble):
            ops = torch.randint(0, 4, (G,), dtype=torch.int32,
                                generator=dgen, device=DEVICE)
            w = [_device_words(dgen, G, 4) for _ in range(4)]
            tw = _device_words(dgen, G)
            if garble:
                r = _device_words(dgen, 1, 4)
                r[:, 0] |= 1
                return ops, w[0], w[1], r.expand(G, 4).contiguous(), tw
            return ops, w[0], w[1], w[2], w[3], tw

        for kname, fn, plain, kernel_sym, nbytes, nops, cold_fn, garble in (
                ("eval_level", lambda: LE.eval_level(*ev),
                 lambda: ref.eval_level(*ev), "eval_level_kernel",
                 LE.EVAL_BYTES, LE.EVAL_OPS, LE.eval_level, False),
                ("garble_level", lambda: LE.garble_level(*ga),
                 lambda: ref.garble_level(*ga), "garble_level_kernel",
                 LE.GARBLE_BYTES, LE.GARBLE_OPS, LE.garble_level, True)):
            bound, by = _bound_ms(G, nbytes, nops)
            row = _cold_row(_timed(fn, plain, kernel_sym),
                            _cold_timed(lambda: cold_level(garble), cold_fn,
                                        G * nbytes, kernel_sym))
            line[kname] = dict(max_abs_err=err[kname], **row,
                               bound_ms=bound, bound_by=by,
                               bound_share=bound / row["ms"])
        rows[G] = line
        print(f"[kernels] G={G}: bit-exact; " + "; ".join(
            f"{k} cold {line[k]['ms']:.5f} ms ({line[k]['cold_buffers']} "
            f"buffers), warm {line[k]['ms_warm']:.5f} (call "
            f"{line[k]['call_ms']:.4f}), plain {line[k]['plain_ms']:.3f}, "
            f"bound {line[k]['bound_ms']:.5f} by {line[k]['bound_by']} "
            f"({100 * line[k]['bound_share']:.0f}% of it when cold)"
            for k in ("eval_level", "garble_level")))
    del v, ev, ga, got, want, gg, gw
    torch.cuda.empty_cache()
    return rows, g_eval, g_garble


def _print_rows(tag, rows):
    for r in rows:
        print(f"[kernels] {tag} {r['shape']}: bit-exact; cold {r['ms']:.5f}"
              f" ms ({r['cold_buffers']} buffers), warm {r['ms_warm']:.5f} "
              f"(call {r['call_ms']:.4f}), plain {r['plain_ms']:.3f}, bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']} "
              f"({100 * r['bound_share']:.0f}% of it when cold)")


def _cold_row(warm, cold):
    """A kernel's timing row: the L2-cold time (``_cold_timed``) as
    ``ms``, the warm one beside it."""
    ms, timing, k = cold
    return dict(ms=ms, timing=timing, cold_buffers=k, ms_warm=warm["ms"],
                timing_warm=warm["timing"], call_ms=warm["call_ms"],
                plain_ms=warm["plain_ms"])


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


def _cold_timed(make_args, fn, nbytes, kernel_sym):
    """L2-cold device time per launch of ``fn(*args)``: launches rotate
    over ``k`` argument sets made by ``make_args()``, ``k`` chosen so that
    more than ``COLD_BYTES`` (inputs read and outputs written, ``nbytes``
    per launch) pass between two uses of a set. Returns (ms, timing, k)."""
    import math

    import torch

    k = max(2, math.ceil(COLD_BYTES / nbytes))
    sets = [make_args() for _ in range(k)]
    outs = []

    def launch_all():
        nonlocal outs
        outs = [fn(*a) for a in sets]

    ms, timing = _cold_ms(launch_all, k, kernel_sym)
    del sets, outs
    torch.cuda.empty_cache()
    return ms, timing, k


def _device_words(gen, *shape):
    import torch

    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         generator=gen, device=DEVICE)


def phase_kernels_ntt(args, n=None):
    """NTT forward and inverse at ring length ``n`` (the HE parameters'
    2048 by default), at the HE primes of a ``PrivacyConfig`` of that
    ring.

    Timed over the rows of a d→d ``he_matvec`` (P x blocks) and over the
    launches of ``mul_plain`` in the HE linear at d→d and d→d_ff (forward
    over the ciphertext pair and the plaintexts, blocks + 2 rows per
    prime; inverse over the 2 x blocks products), the blocks being those
    of that ring's ``matvec_plan``: warm, 20 launches on one input, and
    L2-cold, launches rotating over distinct inputs and outputs that pass
    ``COLD_BYTES`` between two uses of a buffer; device time from the
    profiler (at N = 32768, the top-stage and in-block kernels of one
    call summed). The share of the bound is taken from the cold time.
    Every row count, and a ragged one, is checked bit-exact against the
    plain version in both directions at the HE primes, at a limb prime
    below 46340 (the Pallas kernel's range; none exists for N > 2048) and
    at the largest NTT prime below 2^31."""
    import math

    import torch
    from repro_torch.config import PrivacyConfig
    from repro_torch.core import he as HE
    from repro_torch.kernels.ntt import ntt as NTT
    from repro_torch.kernels.ntt import ref as NR

    pc = PrivacyConfig() if n is None else PrivacyConfig(he_poly_n=n)
    params = HE.make_params(n=pc.he_poly_n, num_primes=pc.he_num_primes,
                            t_bits=pc.he_t_bits)
    n, qs = params.n, params.qs
    P = len(qs)
    sym = ("ntt_kernel", "top_stage_kernel") if n > NTT.MAX_ROW_N \
        else "ntt_kernel"
    extra = [NR.find_ntt_primes(16, 1, n, max_q=NR.INT32_PRODUCT_BOUND)[0]] \
        if n <= 2048 else []
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
        for q in (qs, *extra, q31):
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
                      sym)
        outs = []

        def launch_all():
            nonlocal outs
            outs = [kern(xi, qs) for xi in xs]

        cold, cold_timing = _cold_ms(launch_all, k, sym)
        ops = nrows * (n // 2 * (n.bit_length() - 1) * NTT.OPS_PER_BUTTERFLY
                       + (n // 2 * NTT.OPS_PER_SCALE if inverse else 0))
        # residues in and out, the (P, n, 2) int32 {w, w'} table and the
        # (P, 8) int32 constants
        bound, by = _bound(nrows * n * NTT.BYTES_PER_COEFF + P * n * 8
                           + P * 32, ops)
        rows.append(dict(
            shape=f"{'inverse' if inverse else 'forward'} {what}: P={P} x "
                  f"{per} rows, N={n}",
            what=what, inverse=inverse, P=P, rows=nrows, n=n,
            ms=cold, timing=cold_timing, cold_buffers=k,
            ms_warm=warm["ms"], timing_warm=warm["timing"],
            call_ms=warm["call_ms"], plain_ms=warm["plain_ms"],
            bound_ms=bound, bound_by=by, bound_share=bound / cold, ops=ops,
            launches_per_call=2 if n > NTT.MAX_ROW_N else 1))
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
          f"(int64 in and out) plus the int32 twiddle table; "
          f"{NTT.OPS_PER_BUTTERFLY} int32 operations per butterfly "
          f"(+{NTT.OPS_PER_SCALE} per butterfly of the inverse's last stage "
          "for the n^-1 scale)")
    return rows, err


def phase_ntt_large(args):
    """The NTT above one block's row (N = 16384 in one block of 1024
    threads and 128 KB of shared memory; N = 32768 as a top-stage pass
    over device memory and two sub-rows of 16384): ``phase_kernels_ntt``
    at each ring, i.e. bit-exact checks and profiler times at the launch
    shapes of that ring's HE linear; then
    ``PiTProtocol(PrivacyConfig(he_poly_n=16384))`` key generation on the
    card, whose keys must equal the CPU's."""
    import torch
    from repro_torch.config import PrivacyConfig
    from repro_torch.core.protocol import PiTProtocol
    from repro_torch.kernels.ntt import ntt as NTT

    rows, err = [], 0
    for n in (16384, 32768):
        r, e = phase_kernels_ntt(args, n)
        rows += r
        err = max(err, e)

    keys, secs = {}, {}
    for dev in (DEVICE, "cpu"):
        NTT.reset_launches()
        t0 = time.perf_counter()
        pr = PiTProtocol(PrivacyConfig(he_poly_n=16384), seed=args.seed,
                         device=dev)
        torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t0
        launches = _launches(("ntt",))["ntt"]
        assert (launches > 0) == (dev == DEVICE), (dev, launches)
        keys[dev] = [pr.sk.cpu(), *(c.cpu() for c in pr.pk)]
    assert all(torch.equal(a, b) for a, b in zip(keys[DEVICE], keys["cpu"])), \
        "keygen at he_poly_n=16384: card != cpu"
    print(f"[kernels] PiTProtocol(PrivacyConfig(he_poly_n=16384)) on the "
          f"card: keys == CPU's; {secs[DEVICE]:.3f} s (CPU {secs['cpu']:.3f}"
          " s)")
    return rows, err, {"card_s": secs[DEVICE], "cpu_s": secs["cpu"]}


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
    dgen = torch.Generator(device=DEVICE).manual_seed(args.seed + 1)
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
        def cold_gates(garble, G=G):
            w = [_device_words(dgen, G, 4) for _ in range(4)]
            tw = _device_words(dgen, G)
            if garble:
                r = _device_words(dgen, 1, 4)
                r[:, 0] |= 1
                return w[0], w[1], r.expand(G, 4).contiguous(), tw
            return w[0], w[1], w[2], w[3], tw

        for name, fn, plain, sym, nb, no, kern, garble in (
                ("garble_and", lambda: HK.garble_gates(*ga),
                 lambda: HR.garble_and_gates(*ga), "garble_and_kernel",
                 HK.GARBLE_BYTES, HK.GARBLE_OPS, HK.garble_gates, True),
                ("eval_and", lambda: HK.eval_gates(*ev),
                 lambda: HR.eval_and_gates(*ev), "eval_and_kernel",
                 HK.EVAL_BYTES, HK.EVAL_OPS, HK.eval_gates, False)):
            bound, by = _bound_ms(G, nb, no)
            row = _cold_row(_timed(fn, plain, sym),
                            _cold_timed(lambda: cold_gates(garble), kern,
                                        G * nb, sym))
            hg.append(dict(name=name, shape=f"{name} G={G}", G=G, **row,
                           bound_ms=bound, bound_by=by,
                           bound_share=bound / row["ms"]))
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
        nbytes = G * LS.BYTES_PER_ROW + lead[0] * 16
        bound, by = _bound_ms(G, LS.BYTES_PER_ROW, LS.OPS_PER_ROW,
                              extra_bytes=lead[0] * 16)

        def cold_select(lead=lead):
            return (_device_words(dgen, *lead, 4),
                    _device_words(dgen, lead[0], 1, 4),
                    torch.randint(0, 2, lead, dtype=torch.int32,
                                  generator=dgen, device=DEVICE))

        row = _cold_row(_timed(lambda: LS.select_labels(w0, r, bits),
                               lambda: LR.select_labels(w0, r, bits),
                               "select_labels_kernel"),
                        _cold_timed(cold_select, LS.select_labels, nbytes,
                                    "select_labels_kernel"))
        ls.append(dict(name="select_labels",
                       shape=f"select_labels I={lead[0]} x {lead[1]} wires",
                       G=G, **row, bound_ms=bound, bound_by=by,
                       bound_share=bound / row["ms"]))
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
    got = _launches(("garble_gates", "eval_gates", "select_labels")
                    + LEVEL_KERNELS)
    launches = {"garble_and": got.pop("garble_gates"),
                "eval_and": got.pop("eval_gates"), **got}
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
        return _launches(("ntt",))["ntt"]

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
        launches = _launches(PATH_KERNELS)
        chunk_launches = _launches(LEVEL_KERNELS)
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
        "comm": st.comm_snapshot(),
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
    return res, engine, xs[0], ys


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


def _profiled(run, tag):
    """Wall time of ``run()`` and device seconds and launch count by
    kernel, from a CUDA-only profiler trace; None where it has none
    (``run()`` still runs, once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ran = False
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            ran = True
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
    except (RuntimeError, AssertionError) as e:  # no CUDA activity traced
        print(f"[{tag}] torch.profiler unavailable ({e!r}): not measured")
        if not ran:
            run()
        return None
    by_kernel = {}
    for ev in events:
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            by_kernel[ev.key] = (us / 1e6, ev.count)
    return wall, by_kernel


def phase_profile(engine, x, seq):
    """Device time of one warm request, from a CUDA-only profiler trace."""
    from repro_torch.serve import PrivateRequest

    engine.preprocess(seq, 1)
    got = _profiled(lambda: engine.serve([PrivateRequest(x=x)]), "profile")
    if got is None:
        return None
    wall, by_kernel = got
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


def _span_total(report, name):
    return sum(v["total_s"] for k, v in report.items()
               if k.split("/")[-1] == name)


def _busy_share(run):
    """Wall time of ``run()`` and the device's busy share of it."""
    got = _profiled(run, "net")
    if got is None:
        return None
    wall, by_kernel = got
    busy = sum(t for t, _ in by_kernel.values())
    return {"wall_s": wall, "device_busy_s": busy, "busy_share": busy / wall}


def phase_net(args, serve, serve_ys):
    """The two-party runtime on the card at BERT-base width: a
    ``PitNetServer`` (weights, evaluation) and a ``GarblerEndpoint``
    (input, garbling) on one GPU, the model and inputs of the serving
    phase. Over ``InProcPipe`` with wire v2 (IKNP OT, seed streams, delta
    tables), then over a ``TcpListener`` on 127.0.0.1 (port 0) with wire
    v1: handshake, ``preprocess(requests)``, ``requests`` runs each. The
    revealed outputs must equal the in-process session's at the same
    seed and wire version (a v2 session built here; the serving phase's
    for v1), and each endpoint's per-tag ``WireLedger`` that session's
    metered ``Channel``, offline and online. The launch counters are
    zeroed just before the endpoints are built (their protocols generate
    HE keys) and read after the last run: ``garble_walk``, ``eval_walk``,
    ``select_labels`` and the NTT must have launched. Each endpoint (and
    the in-process session) builds its own netlists and level plans, as
    each party of a deployment does in its own process: the garbler's
    offline time and the server's first run include them. The last v2
    run (warm: its plans are built) runs under the profiler for the
    device's busy share."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.config import BERT_BASE, PrivacyConfig
    from repro_torch.core.engine import PrivateTransformer, random_weights
    from repro_torch.kernels.label_select import label_select as LS
    from repro_torch.kernels.level_eval import level_eval as LE
    from repro_torch.kernels.ntt import ntt as NTT
    from repro_torch.net import (GarblerEndpoint, InProcPipe, PitNetServer,
                                 TcpListener, TcpTransport)

    S, d, dff = args.seq, args.d, args.d_ff
    rng = np.random.default_rng(args.seed)  # the serving phase's draws
    ws = random_weights(rng, d, dff, args.layers)
    xs = rng.normal(0, 1, (args.requests, S, d))
    model = PrivateTransformer(PrivacyConfig(), d, args.heads, dff, ws,
                               seed=args.seed,
                               activation=BERT_BASE.activation,
                               device=DEVICE)
    timeout = 1200

    def two_party(wire, tcp):
        res = {}
        tag = f"v{wire} {'TCP' if tcp else 'InProcPipe'}"
        t0 = time.perf_counter()
        srv = PitNetServer(model, S, device=DEVICE, seed=args.seed)
        if tcp:
            lst = TcpListener("127.0.0.1", 0)
            loop = srv.serve_tcp(lst, timeout=timeout, max_conns=1)
            transport = TcpTransport.connect("127.0.0.1", lst.port)
        else:
            a, b = InProcPipe.make_pair()
            srv.serve_transport(b, timeout=timeout)
            transport = a
        cli = GarblerEndpoint(transport, seed=args.seed, device=DEVICE,
                              timeout=timeout, wire_version=wire)
        cli.handshake()
        torch.cuda.synchronize()
        res["handshake_s"] = time.perf_counter() - t0
        assert cli.shared.negotiated_version == wire
        t0 = time.perf_counter()
        cli.preprocess(args.requests)
        torch.cuda.synchronize()
        res["offline_s"] = time.perf_counter() - t0
        print(f"[net] {tag}: handshake {res['handshake_s']:.2f} s, "
              f"preprocess({args.requests}) {res['offline_s']:.2f} s",
              flush=True)
        ys, t_req = [], []
        for i, x in enumerate(xs):
            t0 = time.perf_counter()
            if wire == 2 and i == len(xs) - 1:
                # the last run is warm (its plans are built): profiled
                res["warm"] = _busy_share(lambda: ys.append(cli.run(x)))
            else:
                ys.append(cli.run(x))
            torch.cuda.synchronize()
            t_req.append(time.perf_counter() - t0)
            print(f"[net] {tag}: run {t_req[-1]:.2f} s", flush=True)
        res["online_s_per_request"] = t_req
        res["ledger"] = {"client": cli.shared.ledger.summary(),
                         "server": srv.shared.ledger.summary()}
        return res, np.stack(ys), cli, srv, (loop, lst) if tcp else None

    def check(tag, ys, res, want_ys, comm):
        assert np.array_equal(ys, want_ys), f"{tag}: outputs != session"
        for side, led in res["ledger"].items():
            for phase in ("offline", "online"):
                got = led[f"{phase}_by_tag"]
                assert got == comm[phase]["by_tag"], \
                    f"{tag}: {side} {phase} ledger != metered session"

    for mod in (LE, NTT, LS):
        mod.reset_launches()
    tracer = obs.enable()
    try:
        v2, ys2, cli, srv, _ = two_party(2, tcp=False)
        launches = _launches(PATH_KERNELS)
        chunk_launches = _launches(LEVEL_KERNELS)
        spans = tracer.report()
        v2["d2h_s"] = _span_total(spans, "net.d2h")
        v2["h2d_s"] = _span_total(spans, "net.h2d")
        v2["walk_host_s"] = {side: _span_total(spans, f"gc_exec.{side}")
                             for side in ("garble", "evaluate")}
        v2["plan_build_s"] = _span_total(spans, "gc_exec.get_executor")
        v2["codec_s"] = {k: _span_total(spans, f"net.{k}")
                         for k in ("encode", "decode")}
        v2["spans_s"] = {k: v["total_s"] for k, v in sorted(
            spans.items(), key=lambda kv: -kv[1]["total_s"])[:30]}
        # the v2 run's trace, for the smokes phase's trace_check
        SMOKES_DIR.mkdir(parents=True, exist_ok=True)
        tracer.export(str(NET_TRACE))
    finally:
        obs.disable()
    assert all(v > 0 for v in launches.values()), launches
    assert not any(chunk_launches.values()), chunk_launches
    cli.close()

    # the check session is untimed: it takes the netlists and level plans
    # the two v2 endpoints built (the garbler's at the preprocess batch,
    # the server's at one request) instead of building them a third time
    t0 = time.perf_counter()
    sess = model.compile_session(S, seed=args.seed, wire_version=2,
                                 device=DEVICE)
    _share_plans(sess.protocol, cli.shared.protocol, srv.shared.protocol)
    bundles = sess.preprocess(args.requests)
    want2 = np.stack([sess.run(x, b) for x, b in zip(xs, bundles)])
    t_sess = time.perf_counter() - t0
    check("v2 pipe", ys2, v2, want2, sess.stats.comm_snapshot())
    print(f"[net] v2: outputs and ledgers == in-process v2 session "
          f"({t_sess:.2f} s, plans shared with the v2 endpoints)",
          flush=True)
    del sess, bundles, cli, srv

    v1, ys1, cli1, srv1, (loop, lst) = two_party(1, tcp=True)
    check("v1 tcp", ys1, v1, serve_ys, serve["comm"])
    assert v1["ledger"]["client"]["seed_stream_segs"] == 0
    cli1.close()
    loop.stop()
    lst.close()

    for tag, r in (("v2 InProcPipe", v2), ("v1 TCP", v1)):
        led = r["ledger"]["client"]
        print(f"[net] {tag}: handshake {r['handshake_s']:.2f} s, offline "
              f"{r['offline_s']:.2f} s for {args.requests} bundles, online "
              + ", ".join(f"{t:.2f}" for t in r["online_s_per_request"])
              + f" s per request; offline {led['offline_bytes'] / 1e6:.2f} "
              f"MB, online {led['online_bytes'] / 1e6:.2f} MB, sideband "
              f"{led['sim_bytes'] / 1e6:.2f} MB")
    print("[net] outputs == in-process session (v2 built here, v1 the "
          "serving phase's), bit for bit; per-tag ledgers == metered "
          "Channel on both endpoints, offline and online")
    for phase in ("offline", "online"):
        by = v2["ledger"]["client"][f"{phase}_by_tag"]
        print(f"[net] v2 {phase} MB by tag: " + "; ".join(
            f"{k} {b / 1e6:.3f}" for k, b in sorted(by.items(),
                                                    key=lambda kv: -kv[1])))
    warm = v2["warm"]
    print(f"[net] v2 copies: D2H {v2['d2h_s']:.3f} s, H2D {v2['h2d_s']:.3f}"
          f" s; walks' host time garble {v2['walk_host_s']['garble']:.3f} s,"
          f" evaluate {v2['walk_host_s']['evaluate']:.3f} s; delta tables "
          f"encode {v2['codec_s']['encode']:.2f} s, decode "
          f"{v2['codec_s']['decode']:.2f} s; plan building "
          f"{v2['plan_build_s']:.2f} s (both endpoints); launches {launches}")
    print("[net] v2 span totals (s, both endpoints): " + "; ".join(
        f"{k} {v:.2f}" for k, v in list(v2["spans_s"].items())[:14]))
    if warm is not None:
        print(f"[net] the last v2 run (warm) under the profiler: wall "
              f"{warm['wall_s']:.2f} s, device busy "
              f"{warm['device_busy_s']:.3f} s "
              f"({100 * warm['busy_share']:.2f}%)")
    print(f"[net] in-process v2 session for the check: {t_sess:.2f} s")
    return ({"v2_pipe": v2, "v1_tcp": v1, "launches": launches,
             "level_launches": chunk_launches, "session_v2_s": t_sess,
             "trace": str(NET_TRACE.relative_to(ROOT))},
            model, xs, srv1.shared)


def _share_plans(dst, *srcs):
    """Hand the protocol ``dst`` the netlists, level plans and executors
    that the protocols ``srcs`` built: the first source's netlist objects
    where ``dst`` has none, and every plan and executor it lacks merged
    into the ones it has (all build the same circuits from the same
    parameters, so plans interoperate). For untimed checks only: a timed
    party builds its own."""
    for src in srcs:
        for name, net in src._netlist_cache.items():
            mine = dst._netlist_cache.setdefault(name, net)
            if mine is net:
                continue
            plans = getattr(mine, "_level_plans", None)
            if plans is None:
                plans = mine._level_plans = {}
            for key, plan in getattr(net, "_level_plans", {}).items():
                have = plans.setdefault(key, plan)
                if have is not plan:
                    for ekey, exe in plan._executors.items():
                        have._executors.setdefault(ekey, exe)


#: the transport op of the resilient client's online leg at which the
#: gateway phase resets it: inside its first run, after the session's
#: base OT, so the server's endpoint dies mid-run and burns the bundle
GATEWAY_RESET_OP = 8
GATEWAY_TIMEOUT_S = 1200


def _gateway_client(role, port, seed, x, device, conn):
    """One client of the ``gateway`` phase, in a process of its own as a
    deployment runs it (spawned: it builds its own protocol and garbling
    plans on its own core). ``role`` is ``"gateway_client"`` (a pipelined
    ``NetPrivateServeEngine``: ``preprocess(1)``, a ``preprocess(2)`` that
    the pool cap sheds, ``run(x)``) or ``"resilient"`` (a
    ``ResilientClient`` whose online leg is reset at
    ``GATEWAY_RESET_OP``: ``preprocess(1)``, ``run(x)``). Sends
    ``("connected", token)`` once admitted, then ``("result", dict)`` or
    ``("error", text)`` on ``conn``."""
    import traceback

    try:
        conn.send(("result", _gateway_client_run(role, port, seed, x, device,
                                                 conn)))
    except BaseException as e:  # reported to the parent, which fails
        conn.send(("error", f"{type(e).__name__}: {e}\n"
                            + traceback.format_exc()))
        raise
    finally:
        conn.close()


def _gateway_client_run(role, port, seed, x, device, conn):
    import torch
    from repro_torch.kernels.label_select import label_select as LS
    from repro_torch.kernels.level_eval import level_eval as LE
    from repro_torch.kernels.ntt import ntt as NTT
    from repro_torch.net import (Deadlines, Fault, FaultSchedule,
                                 FaultyTransport, ResilientClient,
                                 RetryPolicy, TcpTransport)
    from repro_torch.serve import BundlePoolEmpty, gateway_client

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    for mod in (LE, NTT, LS):
        mod.reset_launches()
    out = {"role": role}
    t0 = time.perf_counter()
    if role == "gateway_client":
        cli = gateway_client("127.0.0.1", port, seed=seed, device=device,
                             timeout=GATEWAY_TIMEOUT_S)
        ledger, token = cli.ledger, cli._shared.client_token
    else:
        fts = []

        def connect():
            ft = FaultyTransport(
                TcpTransport.connect("127.0.0.1", port),
                FaultSchedule((Fault(GATEWAY_RESET_OP, "reset"),)
                              if len(fts) == 1 else ()))
            fts.append(ft)
            return ft

        cli = ResilientClient(connect, seed=seed, device=device,
                              deadlines=Deadlines.uniform(GATEWAY_TIMEOUT_S),
                              policy=RetryPolicy(attempts=4, base_s=0.05))
        cli.handshake()
        ledger, token = cli.shared.ledger, cli.shared.client_token
    out["connect_s"] = time.perf_counter() - t0
    conn.send(("connected", token))
    t0 = time.perf_counter()
    cli.preprocess(1)
    sync()
    out["offline_s"] = time.perf_counter() - t0
    if role == "gateway_client":
        c2s = ledger.offline.client_to_server
        try:
            cli.preprocess(2)
        except BundlePoolEmpty as e:
            out["shed"] = (e.scope, e.retry_after_s)
        # shed before the expensive work: no offline PROTO bytes move
        out["shed_c2s_bytes"] = ledger.offline.client_to_server - c2s
    t0 = time.perf_counter()
    out["y"] = cli.run(x)
    sync()
    out["online_s"] = time.perf_counter() - t0
    out["ledger"] = {ph: dict(getattr(ledger, ph).by_tag)
                     for ph in ("offline", "online")}
    out["launches"] = _launches(PATH_KERNELS + LEVEL_KERNELS)
    if role == "resilient":
        out["stats"] = cli.stats()
        out["injected"] = fts[1].injected
    cli.close()
    return out


def phase_gateway(args, model, xs, shared, serve_ys):
    """The multi-client front door on the card at the serving phase's
    model and inputs: a ``PitGateway`` behind one ``TcpListener`` on
    127.0.0.1, over the ``net`` phase's v1 TCP server's ``ServerShared``
    (its plan, protocol and evaluate-side level plans; the sessions
    negotiate wire v2), with ``max_sessions=2``, ``pool_cap=2`` and a
    lease. Two client sessions run at once, each client in a process of
    its own (``_gateway_client``) that builds its own protocol and
    garbling plans: a ``gateway_client`` (``run(xs[0])``, with a
    ``preprocess(2)`` past the pool cap that is shed before anything is
    garbled) and a ``ResilientClient`` (``run(xs[1])``) whose online leg
    is reset at transport op ``GATEWAY_RESET_OP``: it burns that bundle,
    resumes the same session, preprocesses a fresh bundle and runs again.
    A third client is shed at hello. Checked: outputs equal the serving
    phase's bit for bit (the resumed run's too); each session's per-tag
    ledger equals its client's (for the resilient one offline, and online
    up to the run the reset cut); one new garbling slab per distinct
    netlist, used by every admitted prep of both sessions; sheds with
    retry-after hints; the server's burn and resume once it has seen the
    drop, with ``prepped == consumed + outstanding + returned + burned``;
    and, with the launch counters zeroed (in every process) before the
    endpoints are built, ``garble_walk``, ``eval_walk``, ``select_labels``
    and the NTT launched (the clients' key generation) and no per-chunk
    level kernel."""
    import multiprocessing

    import numpy as np
    from repro_torch.kernels.label_select import label_select as LS
    from repro_torch.kernels.level_eval import level_eval as LE
    from repro_torch.kernels.ntt import ntt as NTT
    from repro_torch.net import TcpListener
    from repro_torch.serve import BundlePoolEmpty, PitGateway, gateway_client

    timeout = GATEWAY_TIMEOUT_S
    S = args.seq
    for mod in (LE, NTT, LS):
        mod.reset_launches()
    t_phase = time.perf_counter()
    # pool_cap 2: the resilient client's fresh prep is admitted while the
    # server still counts the cut run in flight (1 + 1 <= 2)
    gw = PitGateway(model, S, device=DEVICE, shared=shared, max_sessions=2,
                    pool_cap=2, lease_s=float(timeout))
    lst = TcpListener("127.0.0.1", 0)
    loop = gw.serve_listener(lst, timeout=timeout)
    slabs_before = dict(shared.gc_cache.summary()["by_key"])

    ctx = multiprocessing.get_context("spawn")
    roles = {"gateway_client": (args.seed + 11, xs[0]),
             "resilient": (args.seed + 12, xs[1])}
    procs, pipes, got = {}, {}, {}
    t0 = time.perf_counter()
    try:
        for role, (seed, x) in roles.items():
            r, w = ctx.Pipe(duplex=False)
            procs[role] = ctx.Process(
                target=_gateway_client, name=f"gateway-{role}",
                args=(role, lst.port, seed, x, DEVICE, w))
            procs[role].start()
            w.close()
            pipes[role] = r

        def receive(role, what):
            deadline = time.monotonic() + timeout
            while not pipes[role].poll(1.0):
                assert procs[role].is_alive() or pipes[role].poll(0), \
                    f"gateway {role} process died ({procs[role].exitcode})"
                assert time.monotonic() < deadline, f"gateway {role} hung"
            kind, payload = pipes[role].recv()
            if kind == "error":
                raise AssertionError(f"gateway {role}: {payload}")
            assert kind == what, (role, kind)
            return payload

        tokens = {role: receive(role, "connected") for role in roles}
        # both sessions are live: a third client is shed at hello
        shed = {}
        try:
            gateway_client("127.0.0.1", lst.port, seed=args.seed + 13,
                           device=DEVICE, timeout=60)
        except BundlePoolEmpty as e:
            shed["session"] = (e.scope, e.retry_after_s)
        got = {role: receive(role, "result") for role in roles}
        t_sessions = time.perf_counter() - t0
    finally:
        for role, p in procs.items():
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert all(p.exitcode == 0 for p in procs.values()), \
        {r: p.exitcode for r, p in procs.items()}
    plain, resil = got["gateway_client"], got["resilient"]
    shed["prep"] = plain.get("shed")
    for scope in ("session", "prep"):
        assert shed[scope] is not None and shed[scope][0] == scope, shed
        assert shed[scope][1] > 0, shed
    assert plain["shed_c2s_bytes"] == 0, plain["shed_c2s_bytes"]
    assert np.array_equal(plain["y"], serve_ys[0]), \
        "gateway_client output != serving phase's"
    assert np.array_equal(resil["y"], serve_ys[1]), \
        "resumed run's output != serving phase's"
    assert resil["injected"] == [(GATEWAY_RESET_OP, "reset")], \
        resil["injected"]
    cst = resil["stats"]
    assert (cst["bundles_burned"], cst["resume_handshakes"]) == (1, 1), cst

    # the server counts the burn once its endpoint has seen the drop
    deadline = time.monotonic() + 300
    while gw.stats()["bundles_burned"] < 1 and time.monotonic() < deadline:
        time.sleep(0.1)
    st = gw.stats()
    assert st["bundles_burned"] == 1 and st["sessions_resumed"] == 1, st
    assert st["sessions_admitted"] == 2 and st["sessions_shed"] == 1, st
    assert st["prep_sheds"] == 1 + cst["sheds_honored"], (st, cst)
    assert st["bundles_prepped"] == (
        st["bundles_consumed"] + st["bundles_outstanding"]
        + st["bundles_returned"] + st["bundles_burned"]), st
    assert (st["bundles_prepped"], st["bundles_consumed"]) == (3, 2), st

    # per-session ledgers, server side == client side
    by_token = {s["client"]: s for s in st["sessions"]}
    srv_plain = by_token[tokens["gateway_client"]]
    for phase in ("offline", "online"):
        assert srv_plain[f"{phase}_by_tag"] == plain["ledger"][phase], phase
    srv_resil = by_token[tokens["resilient"]]
    assert srv_resil["offline_by_tag"] == resil["ledger"]["offline"]
    # online: the retried run complete on both sides, plus part of the cut
    # one: between one and two clean runs' bytes per tag
    clean = plain["ledger"]["online"]
    for side in (srv_resil["online_by_tag"], resil["ledger"]["online"]):
        assert set(side) == set(clean), set(side) ^ set(clean)
        for tag, b in side.items():
            assert clean[tag] <= b <= 2 * clean[tag], (tag, b, clean[tag])

    # one new slab per distinct netlist, shared by every admitted prep
    cache = shared.gc_cache.summary()
    new = {k: v for k, v in cache["by_key"].items() if k not in slabs_before}
    nets = {k.split("/")[0] for k in new}
    assert len(new) == len(nets) == cache["distinct_netlists"], new
    assert set(new.values()) == {st["bundles_prepped"]}, new

    # launches in every process: the server (here) and both clients
    server = _launches(PATH_KERNELS + LEVEL_KERNELS)
    total = {k: server[k] + plain["launches"][k] + resil["launches"][k]
             for k in server}
    launches = {k: total[k] for k in PATH_KERNELS}
    chunk_launches = {k: total[k] for k in LEVEL_KERNELS}
    assert all(v > 0 for v in launches.values()), launches
    assert not any(chunk_launches.values()), chunk_launches
    metrics = gw.metrics()

    loop.stop()
    lst.close()
    gw.close()
    secs = {f"{role} {k}": got[role][k] for role in roles
            for k in ("connect_s", "offline_s", "online_s")}
    res = {"sessions_s": t_sessions,
           "phase_s": time.perf_counter() - t_phase, "seconds": secs,
           "resilient": cst, "sheds": shed, "launches": launches,
           "level_launches": chunk_launches,
           "launches_by_process": {"server": server,
                                   "gateway_client": plain["launches"],
                                   "resilient": resil["launches"]},
           "stats": {k: v for k, v in st.items() if k != "sessions"},
           "metrics": metrics, "new_slabs": new,
           "ledgers_mb": {
               who: {ph: s[f"{ph}_bytes"] / 1e6
                     for ph in ("offline", "online")}
               for who, s in (("gateway_client", srv_plain),
                              ("resilient", srv_resil))}}
    print(f"[gateway] 2 concurrent sessions at BERT-base width over one "
          f"listener (wire v2), each client in its own process: outputs == "
          f"serving phase's bit for bit, the resumed run included; both "
          f"sessions {t_sessions:.2f} s")
    print("[gateway] seconds: " + "; ".join(
        f"{k} {v:.2f}" for k, v in secs.items()))
    print(f"[gateway] sheds (scope, retry_after_s): {shed}; resilient "
          f"client {cst}; gateway burned {st['bundles_burned']}, resumed "
          f"{st['sessions_resumed']}, prepped {st['bundles_prepped']} == "
          f"consumed {st['bundles_consumed']} + outstanding "
          f"{st['bundles_outstanding']} + returned "
          f"{st['bundles_returned']} + burned {st['bundles_burned']}")
    print(f"[gateway] new garbling slabs {new}; launches {launches} (by "
          f"process {res['launches_by_process']}); per-chunk level kernels "
          f"{chunk_launches}")
    print(f"[gateway] metrics: {json.dumps(metrics['counters'])} "
          f"{json.dumps(metrics['gauges'])}")
    return res


def phase_eager(args, serve_ys):
    """``PrivateTransformer.forward_private`` (the eager path: offline and
    online legs per op through the protocol's single-call wrappers) on the
    card at the serving phase's model (BERT-base width, the same weights,
    seed and first input), built anew so it builds its own level plans:
    its revealed output must equal the serving phase's first output bit
    for bit (the eager path draws what one bundle of a session draws).
    Launch counters zeroed just before the model is built."""
    import numpy as np
    import torch
    from repro_torch.config import BERT_BASE, PrivacyConfig
    from repro_torch.core.engine import PrivateTransformer, random_weights
    from repro_torch.kernels.label_select import label_select as LS
    from repro_torch.kernels.level_eval import level_eval as LE
    from repro_torch.kernels.ntt import ntt as NTT

    S, d, dff = args.seq, args.d, args.d_ff
    rng = np.random.default_rng(args.seed)  # the serving phase's draws
    ws = random_weights(rng, d, dff, args.layers)
    x = rng.normal(0, 1, (args.requests, S, d))[0]
    for mod in (LE, LS, NTT):
        mod.reset_launches()
    t0 = time.perf_counter()
    model = PrivateTransformer(PrivacyConfig(), d, args.heads, dff, ws,
                               seed=args.seed,
                               activation=BERT_BASE.activation,
                               device=DEVICE)
    y = model.forward_private(x)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launches(PATH_KERNELS)
    chunk_launches = _launches(LEVEL_KERNELS)
    assert y.shape == (S, d) and np.isfinite(y).all(), y.shape
    assert np.array_equal(y, serve_ys[0]), \
        "forward_private != the serving phase's first output"
    assert all(v > 0 for v in launches.values()), launches
    assert not any(chunk_launches.values()), chunk_launches
    print(f"[eager] forward_private d={d} h={args.heads} d_ff={dff} "
          f"{args.layers} layer(s) S={S} on the card: == the serving "
          f"phase's first output bit for bit, {secs:.1f} s (model built, "
          f"HE keys and level plans included); launches {launches}")
    return {"seconds": secs, "launches": launches,
            "level_launches": chunk_launches,
            "config": dict(d=d, heads=args.heads, d_ff=dff,
                           layers=args.layers, seq=S)}


#: card against CPU at f32 with TF32 off: the same torch ops, sums in
#: another order (cuBLAS against the CPU's BLAS)
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)
#: the architectures of part (d), each at ``reduced_config(...)``
MODEL_OTHERS = ("smollm-360m", "qwen3-1.7b", "deepseek-67b", "olmoe-1b-7b",
                "llama4-scout-17b-a16e", "musicgen-medium", "internvl2-26b",
                "zamba2-2.7b", "xlstm-125m")


def _model_batch(cfg, b, s, rng, decode=False):
    """A prefill batch (or a one-step decode batch) for any input mode."""
    import numpy as np

    if cfg.input_mode == "embeddings":
        return {"embeddings": rng.standard_normal(
            (b, 1 if decode else s, cfg.d_model)).astype(np.float32)}
    n_img = 0 if decode or cfg.input_mode == "tokens" \
        else cfg.num_image_tokens
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (b, 1 if decode else s - n_img))}
    if n_img:
        out["image_embeds"] = rng.standard_normal(
            (b, n_img, cfg.d_model)).astype(np.float32)
    return out


def _leaves(tree):
    return [x for v in tree.values()
            for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _on(batch, dev):
    import torch

    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _card_vs_cpu(cfg, seed, b, s, tag):
    """The same seeded params on the card and the CPU: prefill logits, and
    one decode step from caches grown by 3, must agree within
    ``MODEL_TOL``. Returns the largest differences."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as MT
    from repro_torch.serve.engine import ServeEngine

    params = MT.init_params(cfg, torch.Generator(DEVICE).manual_seed(seed))
    p_cpu = MT.tree_map(lambda a: a.cpu(), params)
    rng = np.random.default_rng(seed)
    batch, step = _model_batch(cfg, b, s, rng), \
        _model_batch(cfg, b, s, rng, decode=True)
    out = {}
    for dev, p in ((DEVICE, params), ("cpu", p_cpu)):
        eng = ServeEngine(cfg, p, capacity=s + 3, batch=b, device=dev)
        logits, caches = eng._prefill(p, _on(batch, dev))
        dlogits, _ = eng._decode(p, _on(step, dev),
                                 eng._grow_caches(caches, s + 3))
        out[dev] = [logits.cpu(), dlogits.cpu()]
    err = []
    for got, want, what in zip(out[DEVICE], out["cpu"],
                               ("prefill", "decode")):
        assert torch.isfinite(got).all(), f"{tag}: {what} logits not finite"
        torch.testing.assert_close(got, want, **MODEL_TOL,
                                   msg=lambda m: f"{tag} {what}: {m}")
        err.append(float((got - want).abs().max()))
    return {"prefill_max_abs_err": err[0], "decode_max_abs_err": err[1]}


def phase_model(args):
    """The model plane's serving half on the card: torch ops (mostly cuBLAS
    products), no kernel of this repository.

    (a) ``llama3.2-1b`` at full width and depth (bf16 compute, f32 master
    params from a seeded generator on the card): ``ServeEngine(capacity=
    256, batch=4)`` answers two batches of 4 requests (128-token prompts
    from ``SyntheticLMData``, 32 new tokens each); tokens in range, logits
    finite; prefill ms per batch, decode ms per step, tokens/s, peak
    memory, then a short generate under the profiler for the device's busy
    share. (b) The same width at 2 layers in f32: prefill logits on the
    card == on the CPU within ``MODEL_TOL``, and the card's greedy tokens
    == the argmax of a full prefill over the grown prompt at each step.
    (c) ``bert-base-pit`` at full width and depth in bf16: prefill at
    batch 4, S=128, finite; 2 layers in f32 card == CPU. (d) Every other
    registered architecture at ``reduced_config`` in f32: prefill and one
    decode step, card == CPU."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import get_config, reduced_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import transformer as MT
    from repro_torch.serve.engine import Request, ServeEngine

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {}

    # (a) full-width serving
    cfg = get_config("llama3.2-1b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = MT.init_params(cfg, torch.Generator(DEVICE).manual_seed(
        args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(a.numel() for a in _leaves(params))
    eng = ServeEngine(cfg, params, capacity=256, batch=4, device=DEVICE)
    clock = {"prefill": [], "decode": []}

    def timed(fn, name):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = fn(*a)
            torch.cuda.synchronize()
            clock[name].append(time.perf_counter() - t)
            assert torch.isfinite(logits).all(), f"{name} logits not finite"
            return logits, caches
        return run

    eng._prefill = timed(eng._prefill, "prefill")
    eng._decode = timed(eng._decode, "decode")
    prompts = SyntheticLMData(cfg, global_batch=8, seq_len=128,
                              seed=args.seed).batch_at(0)["tokens"]
    batches = []
    for i in range(2):
        for v in clock.values():
            v.clear()
        t0 = time.perf_counter()
        done = eng.generate([Request(prompt=p, max_new_tokens=32)
                             for p in prompts[4 * i:4 * i + 4]])
        wall = time.perf_counter() - t0
        toks = np.array([r.out_tokens for r in done])
        assert toks.shape == (4, 32), toks.shape
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        dec = np.array(clock["decode"]) * 1e3
        batches.append({
            "prefill_ms": clock["prefill"][0] * 1e3,
            "decode_ms_per_step": float(dec.mean()),
            "decode_ms_min": float(dec.min()), "decode_ms_max": float(dec.max()),
            "decode_steps": len(dec), "generate_s": wall,
            "tokens_per_s": toks.size / wall})
        print(f"[model] llama3.2-1b full width, batch {i + 1} of 4 requests "
              f"(128-token prompts, 32 new tokens): prefill "
              f"{batches[-1]['prefill_ms']:.2f} ms, decode "
              f"{dec.mean():.3f} ms/step (min {dec.min():.3f}, max "
              f"{dec.max():.3f}, {len(dec)} steps), {toks.size} tokens in "
              f"{wall:.3f} s = {toks.size / wall:.1f} tokens/s", flush=True)
    peak = torch.cuda.max_memory_allocated()
    # one byte-floor yardstick for a decode step: every weight the step
    # multiplies by (all but the embedding table) read once in bf16
    floor_bytes = 2 * (n_params - params["embed"]["table"].numel())
    prof = _profiled(lambda: eng.generate(
        [Request(prompt=p, max_new_tokens=8) for p in prompts[:4]]), "model")
    busy = None
    if prof is not None:
        wall, by_kernel = prof
        busy_s = sum(t for t, _ in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
        busy = {"wall_s": wall, "device_busy_s": busy_s,
                "busy_share": busy_s / wall,
                "top": {k: {"s": t, "count": c} for k, (t, c) in top}}
        print(f"[model] a generate of 4 x 8 tokens under the profiler: wall "
              f"{wall:.3f} s, device busy {busy_s:.3f} s "
              f"({100 * busy_s / wall:.1f}%); top device time (s, count): "
              + "; ".join(f"{k[:40]} {t:.4f} x{c}" for k, (t, c) in top))
    print(f"[model] params {n_params / 1e9:.3f} B in f32, init "
          f"{init_s:.2f} s; peak device memory {peak / 2**30:.2f} GiB; "
          f"decode byte floor (bf16 weights once) "
          f"{floor_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    res["serve"] = {"config": "llama3.2-1b", "params": n_params,
                    "init_s": init_s, "batches": batches,
                    "peak_bytes": peak, "profile": busy,
                    "decode_floor_ms": floor_bytes / HBM_BYTES_PER_S * 1e3}
    del eng, params
    torch.cuda.empty_cache()

    # (b) full width, 2 layers, f32: card == CPU, decode == prefill
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    res["llama_2l_f32"] = _card_vs_cpu(cfg2, args.seed, 2, 32, "llama 2L")
    params = MT.init_params(cfg2, torch.Generator(DEVICE).manual_seed(
        args.seed))
    eng = ServeEngine(cfg2, params, capacity=64, batch=2, device=DEVICE)
    rng = np.random.default_rng(args.seed)
    prompts2 = rng.integers(0, cfg2.vocab_size, (2, 32))
    done = eng.generate([Request(prompt=p, max_new_tokens=8)
                         for p in prompts2])
    for p, r in zip(prompts2, done):
        toks = list(p)
        for t in r.out_tokens:
            logits, _ = eng._prefill(params, {"tokens": torch.tensor(
                [toks], device=DEVICE)})
            assert int(logits[0, :cfg2.vocab_size].argmax()) == t, \
                "card decode != card prefill over the grown prompt"
            toks.append(t)
    res["llama_2l_f32"]["decode_equals_prefill_tokens"] = 16
    print(f"[model] llama3.2-1b 2 layers f32: card == CPU (prefill "
          f"{res['llama_2l_f32']['prefill_max_abs_err']:.2e}, decode "
          f"{res['llama_2l_f32']['decode_max_abs_err']:.2e} max abs); 2 x 8 "
          f"greedy tokens == argmax of a full prefill at each step")
    del eng, params
    torch.cuda.empty_cache()

    # (c) the paper's model
    bert = get_config("bert-base-pit")
    params = MT.init_params(bert, torch.Generator(DEVICE).manual_seed(
        args.seed))
    toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, bert.vocab_size, (4, 128))).to(DEVICE)
    ms = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = MT.forward(bert, params, {"tokens": toks},
                                   mode="prefill")
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    assert logits.shape == (4, bert.padded_vocab)
    assert torch.isfinite(logits).all()
    del params
    res["bert"] = {"prefill_ms": ms, **_card_vs_cpu(
        dataclasses.replace(bert, num_layers=2, dtype="float32"), args.seed,
        4, 128, "bert 2L")}
    print(f"[model] bert-base-pit 12 layers bf16, batch 4 x 128: prefill "
          f"{ms[0]:.2f} ms first, {min(ms[1:]):.2f} ms warm; 2 layers f32 "
          f"card == CPU ({res['bert']['prefill_max_abs_err']:.2e} max abs)")

    # (d) every other registered architecture, reduced, card == CPU
    res["reduced"] = {}
    for name in MODEL_OTHERS:
        res["reduced"][name] = _card_vs_cpu(
            reduced_config(get_config(name)), args.seed, 2, 17, name)
    worst = max(max(v.values()) for v in res["reduced"].values())
    print(f"[model] {len(MODEL_OTHERS)} other architectures (reduced, f32): "
          f"prefill and one decode step card == CPU (worst {worst:.2e} max "
          f"abs; tolerance rtol=atol=2e-3)")
    res["seconds"] = time.perf_counter() - t_phase
    return res


#: train phase (c): the resumed run's setup, as ``tests/test_train.py``'s
RESUME_ARCH, RESUME_BATCH, RESUME_SEQ = "smollm-360m", 4, 32


def _train_state(cfg, seed, dev, step=5):
    """Seeded f32 params drawn on the card, zero Adam moments and ``step``
    (past warm-up, so the learning rate is not 0), on ``dev``."""
    import torch
    from repro_torch.models import transformer as MT
    from repro_torch.train.optimizer import init_opt_state

    params = MT.init_params(cfg, torch.Generator(DEVICE).manual_seed(seed))
    params = MT.tree_map(lambda a: a.to(dev), params)
    return {"params": params, "opt": init_opt_state(params),
            "step": torch.tensor(step, dtype=torch.int32, device=dev)}


def _train_batch(cfg, b, s, rng):
    batch = _model_batch(cfg, b, s, rng)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s))
    return batch


def _step_on(cfg, tc, state, batch, dev):
    from repro_torch.launch.steps import build_train_step

    step, _, _, _ = build_train_step(cfg, tc)
    return step(state, _on(batch, dev))


def _train_card_vs_cpu(cfg, tc, seed, b, s, tag):
    """One train step from the same seeded state on the card and the CPU:
    loss, grad_norm and every updated leaf of params and moments within
    ``MODEL_TOL``. Returns the largest differences and the card's state."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as MT

    batch = _train_batch(cfg, b, s, np.random.default_rng(seed))
    out = {}
    for dev in (DEVICE, "cpu"):
        state = _train_state(cfg, seed, dev)
        out[dev] = _step_on(cfg, tc, state, batch, dev)
    (g_state, g_met), (c_state, c_met) = out[DEVICE], out["cpu"]
    err = {}
    for k in ("loss", "grad_norm", "aux"):
        got, want = g_met[k].cpu(), c_met[k]
        assert torch.isfinite(got), f"{tag}: {k} not finite"
        torch.testing.assert_close(got, want, **MODEL_TOL,
                                   msg=lambda m: f"{tag} {k}: {m}")
        err[k] = float((got - want).abs())
    for part in ("params", "m", "v"):
        g_tree = g_state["params"] if part == "params" \
            else g_state["opt"][part]
        c_tree = c_state["params"] if part == "params" \
            else c_state["opt"][part]
        worst = 0.0
        for got, want in zip(_leaves(g_tree), _leaves(c_tree)):
            got = got.cpu()
            torch.testing.assert_close(got, want, **MODEL_TOL,
                                       msg=lambda m: f"{tag} {part}: {m}")
            worst = max(worst, float((got - want).abs().max()))
        err[part] = worst
    del c_state
    return err, g_state, g_met


def _resume_child():
    """Train phase (c), in a process of its own: ``CUBLAS_WORKSPACE_CONFIG``
    is set before CUDA starts and deterministic algorithms are on (the
    gather backwards of the embedding and of the loss scatter-add on
    CUDA). 8 steps straight against 4, a checkpoint, a new trainer that
    resumes it and 4 more: losses and final state must be bit-identical.
    Prints one JSON line."""
    import tempfile

    import torch
    from repro_torch.config import TrainConfig, get_config, reduced_config
    from repro_torch.train.trainer import Trainer

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(get_config(RESUME_ARCH))

    def trainer(d):
        tc = TrainConfig(total_steps=10, warmup_steps=2, checkpoint_every=4,
                         checkpoint_dir=d, seed=0)
        return Trainer(cfg, tc, global_batch=RESUME_BATCH,
                       seq_len=RESUME_SEQ, device=DEVICE)

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        tr = trainer(d1)
        tr.init_or_resume(resume=False)
        full = tr.run(8, with_guard=False)["losses"]
        straight = _leaves(tr.state)
        tr1 = trainer(d2)
        tr1.init_or_resume(resume=False)
        part1 = tr1.run(4, with_guard=False)["losses"]
        tr2 = trainer(d2)
        resumed_at = tr2.init_or_resume(resume=True)
        part2 = tr2.run(4, with_guard=False)["losses"]
        resumed = _leaves(tr2.state)
    same = [bool(torch.equal(a, b)) for a, b in zip(straight, resumed)]
    print(json.dumps({
        "resumed_at": resumed_at, "losses": full,
        "losses_resumed": part1 + part2,
        "losses_equal": full == part1 + part2,
        "leaves": len(same), "leaves_equal": sum(same),
        "max_abs_diff": max(float((a - b).abs().max())
                            for a, b in zip(straight, resumed))}))


def phase_train(args):
    """Training on one card: torch ops (mostly cuBLAS products) and
    autograd, no kernel of this repository.

    (a) ``llama3.2-1b`` at full width and depth (bf16 compute, f32 master
    params and Adam moments, block remat) trained by ``Trainer`` on the
    card: global batch 8 × 4,096 tokens (``train_4k``'s length) as 8
    microbatches, 3 steps; each step's seconds, loss and grad norm
    (finite; the first loss within 1.0 of ln(vocab) + z-loss), tokens/s
    and the model-FLOP share of the card's bf16 peak from the second
    step, peak memory, and the device's busy share of the third, run
    under the profiler. (b) The
    same width at 2 layers in f32 (TF32 off), batch 2 × 128: one
    ``build_train_step`` step from the same state on the card and the
    CPU, within ``MODEL_TOL``. (c) Resume bit for bit on the card
    (``_resume_child``). (d) Every other registered architecture, reduced:
    one step card == CPU, and block remat on == off on the card."""
    import dataclasses
    import math
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch.config import (ShapeConfig, TrainConfig, get_config,
                                    reduced_config)
    from repro_torch.roofline import HW, model_flops
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    res = {}

    # (a) full width and depth
    cfg = get_config("llama3.2-1b")
    B, S, mb = 8, 4096, 8
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt:
        tc = TrainConfig(microbatches=mb, checkpoint_every=10**9,
                         checkpoint_dir=ckpt, seed=args.seed)
        tr = Trainer(cfg, tc, global_batch=B, seq_len=S, device=DEVICE)
        t0 = time.perf_counter()
        tr.init_or_resume(resume=False)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        steps, ran = [], []
        for i in range(3):  # the third under the profiler
            t0 = time.perf_counter()
            if i < 2:
                ran.append(tr.run(1, with_guard=False))
            else:
                prof = _profiled(
                    lambda: ran.append(tr.run(1, with_guard=False)), "train")
            torch.cuda.synchronize()
            steps.append({"s": time.perf_counter() - t0,
                          "profiled": i == 2, **ran[-1]["metrics"][0]})
        peak = torch.cuda.max_memory_allocated()
    n_params = sum(a.numel() for a in _leaves(tr.state["params"]))
    del tr
    torch.cuda.empty_cache()
    for st in steps:
        assert math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]), st
    logz = math.log(cfg.vocab_size)
    want = logz + tc.z_loss * logz ** 2
    assert abs(steps[0]["loss"] - want) < 1.0, (steps[0]["loss"], want)
    warm = steps[1]["s"]
    flops = model_flops(cfg, ShapeConfig("train", S, B, "train"))
    mfu = flops / warm / HW().peak_flops
    busy = None
    if prof is not None:
        wall, by_kernel = prof
        busy_s = sum(t for t, _ in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
        busy = {"wall_s": wall, "device_busy_s": busy_s,
                "busy_share": busy_s / wall,
                "top": {k: {"s": t, "count": c} for k, (t, c) in top}}
    res["full"] = {"config": "llama3.2-1b", "params": n_params,
                   "global_batch": B, "seq_len": S, "microbatches": mb,
                   "init_s": init_s, "steps": steps, "warm_step_s": warm,
                   "tokens_per_s": B * S / warm, "peak_bytes": peak,
                   "model_flops": flops, "model_flop_share": mfu,
                   "first_loss_expected": want, "profile": busy,
                   "part_s": time.perf_counter() - t_phase}
    print("[train] llama3.2-1b full width and depth, bf16 compute, f32 "
          f"master + Adam, block remat, {B} x {S} tokens as {mb} "
          f"microbatches: steps (the third profiled) " + "; ".join(
              f"{st['s']:.3f} s loss {st['loss']:.4f} grad_norm "
              f"{st['grad_norm']:.4f}" for st in steps)
          + f"; warm {warm:.3f} s = {B * S / warm:.1f} tokens/s; "
          f"model-FLOP share {100 * mfu:.2f}% of {HW().peak_flops / 1e12:.0f}"
          f" TFLOP/s; peak device memory {peak / 2**30:.2f} GiB; params "
          f"{n_params / 1e9:.3f} B, init {init_s:.2f} s", flush=True)
    if busy is not None:
        print(f"[train] one step under the profiler: wall {busy['wall_s']:.3f}"
              f" s, device busy {busy['device_busy_s']:.3f} s "
              f"({100 * busy['busy_share']:.1f}%); top device time (s, "
              "count): " + "; ".join(
                  f"{k[:40]} {v['s']:.3f} x{v['count']}"
                  for k, v in busy["top"].items()), flush=True)

    # (b) the same width at 2 layers, f32: card == CPU
    t_part = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    tc2 = TrainConfig(warmup_steps=3, seed=args.seed)
    err, _, met = _train_card_vs_cpu(cfg2, tc2, args.seed, 2, 128,
                                     "llama 2L train")
    res["llama_2l_f32"] = {**err, "loss": float(met["loss"]),
                           "part_s": time.perf_counter() - t_part}
    print(f"[train] llama3.2-1b 2 layers f32, 2 x 128: one step card == CPU "
          f"(loss {float(met['loss']):.5f}, max abs: loss {err['loss']:.2e}, "
          f"grad_norm {err['grad_norm']:.2e}, params {err['params']:.2e}, m "
          f"{err['m']:.2e}, v {err['v']:.2e})", flush=True)
    torch.cuda.empty_cache()

    # (c) resume bit for bit, in a process of its own
    t_part = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--train-resume-child"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    resume = json.loads(out.stdout.strip().splitlines()[-1])
    assert resume["resumed_at"] == 4, resume
    assert resume["losses_equal"], resume
    assert resume["leaves_equal"] == resume["leaves"], resume
    res["resume"] = {**resume, "part_s": time.perf_counter() - t_part}
    print(f"[train] resume on the card ({RESUME_ARCH} reduced, "
          f"{RESUME_BATCH} x {RESUME_SEQ}, deterministic algorithms): 8 "
          f"losses and all {resume['leaves']} state leaves of a run resumed "
          "at step 4 == the uninterrupted run, bit for bit", flush=True)

    # (d) every other architecture, reduced
    t_part = time.perf_counter()
    res["reduced"] = {}
    for name in MODEL_OTHERS + ("bert-base-pit",):
        small = reduced_config(get_config(name))
        err, on_state, _ = _train_card_vs_cpu(small, tc2, args.seed, 2, 64,
                                              name)
        off = dataclasses.replace(small, remat="none")
        batch = _train_batch(small, 2, 64, np.random.default_rng(args.seed))
        off_state, _ = _step_on(off, tc2, _train_state(off, args.seed,
                                                       DEVICE), batch, DEVICE)
        diffs = [float((a - b).abs().max()) for a, b in
                 zip(_leaves(on_state), _leaves(off_state))]
        for a, b in zip(_leaves(on_state), _leaves(off_state)):
            torch.testing.assert_close(
                a, b, **MODEL_TOL, msg=lambda m: f"{name} remat: {m}")
        err["remat_max_abs_diff"] = max(diffs)
        err["remat_bitwise"] = max(diffs) == 0.0
        res["reduced"][name] = err
    n_bit = sum(v["remat_bitwise"] for v in res["reduced"].values())
    worst = max(max(v[k] for k in ("loss", "grad_norm", "params", "m", "v"))
                for v in res["reduced"].values())
    print(f"[train] {len(res['reduced'])} other architectures (reduced, f32):"
          f" one step card == CPU (worst {worst:.2e} max abs; tolerance "
          f"rtol=atol=2e-3); block remat on == off on the card, bit for bit "
          f"in {n_bit} of {len(res['reduced'])} (worst "
          f"{max(v['remat_max_abs_diff'] for v in res['reduced'].values()):.2e})",
          flush=True)
    res["reduced_part_s"] = time.perf_counter() - t_part
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[train] phase {res['seconds']:.1f} s: (a) "
          f"{res['full']['part_s']:.1f}, (b) "
          f"{res['llama_2l_f32']['part_s']:.1f}, (c) "
          f"{res['resume']['part_s']:.1f}, (d) {res['reduced_part_s']:.1f}",
          flush=True)
    return res


#: phase 15: ranks, their default backend (on one card: gloo with the
#: collectives it cannot run on CUDA tensors staged through host memory;
#: NCCL refuses two ranks on one GPU), and the seconds the ranks may take
MESH_RANKS, MESH_BACKEND, MESH_CHILD_TIMEOUT = 4, "gloo-staged", 420
#: (a) OLMoE-1B-7B served at full width and depth on (data=1, model=4)
MESH_SERVE_ARCH, MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_STEPS = \
    "olmoe-1b-7b", 4, 128, 16
#: (c) Llama-3.2-1B trained at full width and depth on (data=2, model=2);
#: the sequence cut from train_4k's 4,096 to 1,024 for the phase's time
#: (on one H100 at 700 W a step of 4 x 4,096 tokens took 76 s over the
#: host-staged collectives)
MESH_TRAIN_ARCH, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_MB, \
    MESH_TRAIN_STEPS = "llama3.2-1b", 4, 1024, 2, 2
#: the first 4-rank loss against one rank's on the same batch and seed
#: (bf16 compute, sums in another order)
MESH_TRAIN_LOSS_RTOL = 2e-2
#: (b) the reduced architectures: batch, prompt, the meshes, and the
#: layers (2: a hybrid's one super-block)
MESH_B, MESH_S, MESH_MESHES, MESH_LAYERS = 4, 16, ((2, 2), (1, 4)), 2
#: (b) starts no case past this many seconds of the ranks' run (the phase
#: keeps to 240 s): every architecture on (2, 2) first, then (1, 4)
MESH_REDUCED_BY = 190
#: (d) the ring's lengths: one the ranks divide, one they pad
MESH_RING = (1 << 20, (1 << 20) - 3)


def _mesh_emit(rank, key, rec):
    """Rank 0's record of one part, as a ``MESH`` line for the parent."""
    if rank == 0:
        print("MESH " + json.dumps({key: rec}, default=float), flush=True)


def _mesh_peaks():
    """Every rank's peak device memory (GiB), gathered."""
    import torch
    import torch.distributed as dist

    mine = torch.cuda.max_memory_allocated() / 2**30
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _grow(caches, extra):
    """Decode caches with ``extra`` more time slots (zeros) after the
    prefill's: k and v are (stack, B, T, KV, hd); the recurrent states
    stay as they are."""
    import torch

    def rec(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = rec(v)
            elif k in ("k", "v"):
                v = _full(v)
                pad = torch.zeros((*v.shape[:2], extra, *v.shape[3:]),
                                  dtype=v.dtype, device=v.device)
                out[k] = torch.cat([v, pad], dim=2)
            else:
                out[k] = _full(v)
        return out

    return {"layers": rec(caches["layers"]), "len": caches["len"]}


def _mesh_ring(rank, dev, seed):
    """(d) ``compressed_psum`` over a (data=4) mesh on the card against the
    same ring on CPU tensors: bit-equal, and near the exact sum."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.compression import (_ring_allreduce_int8,
                                               compressed_psum)

    import torch.distributed as dist

    mesh = make_mesh((MESH_RANKS,), ("data",), device=DEVICE)
    # the CPU ring runs over a gloo group of the same ranks (NCCL takes no
    # host tensor)
    group = dist.new_group(list(range(MESH_RANKS)), backend="gloo")
    out = {}
    for n in MESH_RING:
        parts = np.random.default_rng(seed + n).standard_normal(
            (MESH_RANKS, n)).astype(np.float32)
        mine = torch.from_numpy(parts[rank])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = compressed_psum(mine.to(dev), "data", mesh)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        cpu = _ring_allreduce_int8(mine.clone(), group)
        exact = parts.sum(0)
        rel = float(np.abs(card.cpu().numpy() - exact).max()
                    / np.abs(exact).max())
        out[str(n)] = {"bit_equal_cpu": bool(torch.equal(card.cpu(), cpu)),
                       "rel_err": rel, "ms": ms,
                       "wire_bytes_per_rank": 2 * (MESH_RANKS - 1)
                       * (-(-n // MESH_RANKS) + 4)}
    return out


def _mesh_ckpt(rank, dev, seed):
    """(e) Sharded checkpoints (reduced ``llama3.2-1b``, (2, 2)): a 4-rank
    save restored on one rank, and a one-rank save restored onto 4 ranks
    with ``shardings=``, bit for bit."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.config import TrainConfig, get_config, reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (abstract_state, lay_out,
                                          state_shardings)
    from repro_torch.models.transformer import init_params
    from repro_torch.train import checkpoint as CK

    cfg = reduced_config(get_config("llama3.2-1b"))
    mesh = make_mesh((2, 2), ("data", "model"), device=DEVICE)
    sh = state_shardings(cfg, abstract_state(cfg, TrainConfig()), mesh)
    gen = torch.Generator(dev).manual_seed(seed)
    params = init_params(cfg, gen)
    state = {"params": params,
             "opt": {k: _mesh_tree_randn(params, gen) for k in ("m", "v")},
             "step": torch.tensor(3, dtype=torch.int32, device=dev)}
    box = [tempfile.mkdtemp(prefix="mesh_ckpt_") if rank == 0 else None]
    dist.broadcast_object_list(box)
    d = box[0]
    try:
        CK.save(f"{d}/four", 3, lay_out(state, sh, mesh))
        same_one = True
        if rank == 0:
            step, st = CK.restore(f"{d}/four", device=dev)
            same_one = step == 3 and all(
                torch.equal(a, b) for a, b in zip(_leaves(st),
                                                  _leaves(state)))
            CK.save(f"{d}/one", 4, state)
        dist.barrier()
        step, st = CK.restore(f"{d}/one", shardings=sh, device=dev)
        full = [_full(x) for x in _leaves(st)]
        same_four = step == 4 and all(torch.equal(a, b) for a, b in
                                      zip(full, _leaves(state)))
        local = sum(x.to_local().numel() for x in _leaves(st))
    finally:
        dist.barrier()
        if rank == 0:
            shutil.rmtree(d, ignore_errors=True)
    return {"four_to_one_bitwise": bool(same_one),
            "one_to_four_bitwise": bool(same_four),
            "leaves": len(full), "local_elems_rank0": local,
            "elems": sum(x.numel() for x in full)}


def _mesh_tree_randn(tree, gen):
    import torch

    return {k: _mesh_tree_randn(v, gen) if isinstance(v, dict) else
            torch.randn(v.shape, generator=gen, device=v.device) * 1e-3
            for k, v in tree.items()}


def _mesh_reduced(rank, dev, seed, deadline):
    """(b) Every registered architecture at ``reduced_config`` (f32, TF32
    off) on 4 ranks == one rank, on each mesh of ``MESH_MESHES``: prefill
    logits and caches, one decode step, one train step's loss, grad norm
    and params, within ``MODEL_TOL``. Expert-parallel configs get a
    capacity for every token here. Returns the worst differences."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.config import (ShapeConfig, TrainConfig, get_config,
                                    list_configs, reduced_config)
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.utils.tree import tree_map

    B, S = MESH_B, MESH_S
    tc = TrainConfig(total_steps=20, warmup_steps=3, seed=seed)
    out = {}
    for mshape in MESH_MESHES:
        mesh = make_mesh(mshape, ("data", "model"), device=DEVICE)
        for name in list_configs():
            if time.perf_counter() > deadline:
                break
            cfg = reduced_config(get_config(name), num_layers=MESH_LAYERS)
            if cfg.moe_impl == "a2a":
                # capacity for every token: the expert-parallel path drops
                # none, so it computes what one rank's dense path does
                cfg = dataclasses.replace(
                    cfg, capacity_factor=cfg.num_experts
                    / cfg.num_experts_per_token)
            t0 = time.perf_counter()
            params = init_params(cfg, torch.Generator(dev).manual_seed(seed))
            rng = np.random.default_rng(seed)
            batch = _on(_model_batch(cfg, B, S, rng), dev)
            step_b = _on(_model_batch(cfg, B, S, rng, decode=True), dev)
            n_lab = S
            labels = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, n_lab)).astype(np.int32)).to(dev)
            errs = {}

            def cmp(what, got, want):
                got, want = _full(got), _full(want)
                if rank == 0:
                    assert torch.isfinite(got).all(), (name, what)
                    torch.testing.assert_close(
                        got, want, **MODEL_TOL,
                        msg=lambda m: f"{name} {mshape} {what}: {m}")
                    errs[what] = max(errs.get(what, 0.0),
                                     float((got - want).abs().max()))

            p1, _, _, _ = ST.build_prefill_step(cfg)
            p4, _, _, _ = ST.build_prefill_step(
                cfg, mesh, ShapeConfig("p", S, B, "prefill"))
            l1, c1 = p1(params, batch)
            l4, c4 = p4(params, batch)
            cmp("prefill_logits", l4, l1)
            for a, b in zip(_leaves(c4["layers"]), _leaves(c1["layers"])):
                cmp("prefill_caches", a, b)
            grown = _grow(c1, 4)
            d1, _, _, _ = ST.build_decode_step(cfg)
            d4, _, _, _ = ST.build_decode_step(
                cfg, mesh, ShapeConfig("d", S + 4, B, "decode"))
            cmp("decode_logits", d4(params, step_b, grown)[0],
                d1(params, step_b, grown)[0])

            def fresh():
                p = tree_map(torch.clone, params)
                return {"params": p, "opt": init_opt_state(p),
                        "step": torch.tensor(5, dtype=torch.int32,
                                             device=dev)}

            tb = {**batch, "labels": labels}
            t1, _, _, _ = ST.build_train_step(cfg, tc)
            t4, _, _, _ = ST.build_train_step(
                cfg, tc, mesh, ShapeConfig("t", S, B, "train"))
            s1, m1 = t1(fresh(), tb)
            s4, m4 = t4(fresh(), tb)
            for k in ("loss", "grad_norm"):
                cmp(f"train_{k}", m4[k], m1[k])
            for a, b in zip(_leaves(s4["params"]), _leaves(s1["params"])):
                cmp("train_params", a, b)
            out[f"{name} {mshape[0]}x{mshape[1]}"] = {
                **errs, "s": time.perf_counter() - t0}
    return out


def _mesh_serve(rank, dev, seed):
    """(a) OLMoE-1B-7B at full width and depth served on (data=1, model=4):
    bf16 serving params (TP-only, 16 experts a rank) drawn leaf by leaf as
    each rank's blocks, a prefill of 4 x 128 tokens, then 16 greedy decode
    steps through the mesh builders (expert-parallel MoE)."""
    import torch
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE

    cfg = get_config(MESH_SERVE_ARCH)
    B, S, n = MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_STEPS
    mesh = make_mesh((1, MESH_RANKS), ("data", "model"), device=DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prefill, in_sh, _, rules = ST.build_prefill_step(
        cfg, mesh, ShapeConfig("prefill", S, B, "prefill"))
    decode, _, _, _ = ST.build_decode_step(
        cfg, mesh, ShapeConfig("decode", S + n, B, "decode"))
    params = _mesh_local_params(cfg, in_sh[0], seed, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    local_bytes = sum(x.to_local().numel() * x.element_size()
                      for x in _leaves(params))
    tokens = torch.from_numpy(SyntheticLMData(cfg, B, S, seed=seed)
                              .batch_at(0)["tokens"]).to(dev)
    ep = [0]
    moe_ep = MOE._moe_ep

    def counted(*a):
        ep[0] += 1
        return moe_ep(*a)

    MOE._moe_ep = counted
    try:
        times = []
        for _ in range(2):  # the second prefill is the warm one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        caches = _grow(caches, n)
        out_tokens, step_ms = [], []
        for i in range(n):
            nxt = _full(logits).argmax(-1)
            out_tokens.append(nxt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode(params, {"tokens": nxt[:, None]}, caches)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
        last = _full(logits)
    finally:
        MOE._moe_ep = moe_ep
    toks = torch.stack(out_tokens, 1)
    assert torch.isfinite(last).all() and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all()), "serve output"
    assert ep[0] == cfg.num_layers * (2 + n), ep  # every MoE layer, EP
    warm = step_ms[2:]
    return {"config": MESH_SERVE_ARCH, "mesh": [1, MESH_RANKS],
            "experts_per_rank": cfg.num_experts // MESH_RANKS,
            "batch": B, "prompt": S, "decode_steps": n,
            "init_s": init_s, "prefill_ms_cold": times[0],
            "prefill_ms": times[1], "decode_ms_per_step": sum(warm)
            / len(warm), "decode_ms_first": step_ms[0],
            "decode_tokens_per_s": B * len(warm) / (sum(warm) / 1e3),
            "ep_calls": ep[0], "param_bytes_rank0": local_bytes,
            "peak_gib": _mesh_peaks(),
            "tokens_head": toks[0, :8].tolist()}


def _mesh_local_params(cfg, shardings, seed, dev):
    """Serving params of ``cfg`` (``serve_param_struct``: bf16 matrices,
    f32 vectors) as DTensors laid out by ``shardings``, each rank keeping
    only its block: every leaf is drawn from a generator of its own on the
    card (a stacked leaf one layer at a time, so no f32 leaf is ever
    whole), N(0, 1/fan-in) for matrices, N(0, 0.02) for tables, ones for
    scales, zeros for biases; every rank draws the same values, and cuts
    its block."""
    import math

    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.launch.steps import serve_param_struct

    counter = [0]

    def leaf(path, st, sh):
        shape = tuple(st.shape)
        local, off = compute_local_shape_and_global_offset(
            shape, sh.mesh, sh.placements)
        name = path[-1]
        counter[0] += 1
        if name in ("scale", "d_skip"):
            block = torch.ones(local, dtype=st.dtype, device=dev)
        elif name in ("bias", "dt_bias", "a_log"):
            block = torch.zeros(local, dtype=st.dtype, device=dev)
        else:
            stacked = "stacked" in path
            std = 0.02 if name == "table" else 1.0 / math.sqrt(shape[-2])
            cut = tuple(slice(o, o + k) for o, k in
                        zip(off[stacked:], local[stacked:]))
            blocks = []
            for layer in range(shape[0] if stacked else 1):
                g = torch.Generator(dev).manual_seed(
                    seed * 1_000_003 + counter[0] * 1_009 + layer)
                whole = torch.randn(shape[stacked:], generator=g,
                                    device=dev) * std
                blocks.append(whole[cut].to(st.dtype).clone())
                del whole
            block = torch.stack(blocks) if stacked else blocks[0]
        return DTensor.from_local(
            block, sh.mesh, sh.placements, run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    def rec(st, sh, path):
        return {k: rec(st[k], sh[k], path + (k,)) if isinstance(st[k], dict)
                else leaf(path + (k,), st[k], sh[k]) for k in st}

    return rec(serve_param_struct(cfg), shardings, ())


def _mesh_train(rank, dev, seed):
    """(c) Llama-3.2-1B at full width and depth trained by ``Trainer(mesh=
    (data=2, model=2), shape=)``: FSDP + TP, the bf16 cast before the FSDP
    gather, block remat, global batch 4 x ``MESH_TRAIN_SEQ`` as 2
    microbatches, 2 steps."""
    import math
    import tempfile

    import torch
    from repro_torch.config import ShapeConfig, TrainConfig, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import Trainer

    cfg = get_config(MESH_TRAIN_ARCH)
    B, S = MESH_TRAIN_BATCH, MESH_TRAIN_SEQ
    mesh = make_mesh((2, 2), ("data", "model"), device=DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt:
        tc = TrainConfig(microbatches=MESH_TRAIN_MB,
                         checkpoint_every=10**9, checkpoint_dir=ckpt,
                         seed=seed)
        tr = Trainer(cfg, tc, global_batch=B, seq_len=S, mesh=mesh,
                     shape=ShapeConfig("train", S, B, "train"), device=dev)
        t0 = time.perf_counter()
        tr.init_or_resume(resume=False)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        steps = []
        for _ in range(MESH_TRAIN_STEPS):
            t0 = time.perf_counter()
            met = tr.run(1, with_guard=False)["metrics"][0]
            torch.cuda.synchronize()
            steps.append({"s": time.perf_counter() - t0, **met})
    for st in steps:
        assert math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])
    warm = steps[-1]["s"]
    return {"config": MESH_TRAIN_ARCH, "mesh": [2, 2], "global_batch": B,
            "seq_len": S, "microbatches": MESH_TRAIN_MB, "init_s": init_s,
            "steps": steps, "warm_step_s": warm,
            "tokens_per_s": B * S / warm, "peak_gib": _mesh_peaks()}


def _mesh_child(args):
    """The ranks of phase 15 (``torch.distributed.run``): parts (d), (e),
    (a), (c) and (b) in that order; rank 0 prints one ``MESH`` JSON line a
    part."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import STAGED, backend_name, init_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_ranks(args.mesh_backend, device=DEVICE)
    rank = dist.get_rank()
    t0 = time.perf_counter()
    _mesh_emit(rank, "backend", {
        "name": backend_name(),
        "staged": list(STAGED) if backend_name() == "gloo-staged" else [],
        "ranks": dist.get_world_size(), "device": str(dev),
        "cards": torch.cuda.device_count(),
        "card": torch.cuda.get_device_name(dev)})
    for key, part in (("ring", lambda: _mesh_ring(rank, dev, args.seed)),
                      ("ckpt", lambda: _mesh_ckpt(rank, dev, args.seed)),
                      ("serve", lambda: _mesh_serve(rank, dev, args.seed)),
                      ("train", lambda: _mesh_train(rank, dev, args.seed)),
                      ("reduced", lambda: _mesh_reduced(
                          rank, dev, args.seed, t0 + MESH_REDUCED_BY))):
        t_part = time.perf_counter()
        rec = part()
        torch.cuda.synchronize()
        dist.barrier()
        _mesh_emit(rank, key, {"result": rec,
                               "part_s": time.perf_counter() - t_part})
    dist.destroy_process_group()


def phase_mesh(args):
    """The multi-rank plane on the card: 4 ranks on the one card over
    ``gloo-staged`` (``launch/mesh.py``), in child processes started by
    ``torch.distributed.run`` (``_mesh_child``); torch ops and DTensor
    collectives, no kernel of this repository. A failing rank fails the
    phase. Then, in this process, one rank's first step of (c) on the same
    batch and seed, whose loss the 4-rank run's must equal within
    ``MESH_TRAIN_LOSS_RTOL``."""
    import os
    import signal

    import torch
    from repro_torch.config import TrainConfig, get_config, list_configs
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={MESH_RANKS}", str(Path(__file__).resolve()),
           "--mesh-child", "--seed", str(args.seed), "--mesh-backend",
           getattr(args, "mesh_backend", MESH_BACKEND)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=MESH_CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"mesh ranks past {MESH_CHILD_TIMEOUT} s: "
                             f"{out[-3000:]} {err[-6000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, f"mesh ranks failed: {out[-3000:]} " \
        f"{err[-8000:]}"
    res = {}
    for line in out.splitlines():
        if line.startswith("MESH "):
            res.update(json.loads(line[5:]))
    assert set(res) == {"backend", "ring", "ckpt", "reduced", "serve",
                        "train"}, sorted(res)
    ranks_s = time.perf_counter() - t_phase
    bk = res["backend"]
    print(f"[mesh] {bk['ranks']} ranks on {bk['cards']} card(s) (rank 0 "
          f"on {bk['device']}, {bk['card']}), backend {bk['name']} (staged "
          f"through pinned host buffers: {'; '.join(bk['staged']) or 'none'})",
          flush=True)
    ring = res["ring"]["result"]
    for n, r in ring.items():
        assert r["bit_equal_cpu"] and r["rel_err"] < 0.08, (n, r)
    print("[mesh] (d) compressed_psum (int8 ring) on the card == the CPU "
          "ring bit for bit; relative error against the exact sum " +
          ", ".join(f"{r['rel_err']:.4f} at {n} ({r['ms']:.1f} ms)"
                    for n, r in ring.items()), flush=True)
    ck = res["ckpt"]["result"]
    assert ck["four_to_one_bitwise"] and ck["one_to_four_bitwise"], ck
    assert ck["local_elems_rank0"] < ck["elems"], ck
    print(f"[mesh] (e) checkpoints: 4-rank save -> 1-rank restore and "
          f"1-rank save -> restore(shardings=) on 4 ranks, all "
          f"{ck['leaves']} leaves bit for bit (rank 0 holds "
          f"{ck['local_elems_rank0']} of {ck['elems']} elements)",
          flush=True)
    red = res["reduced"]["result"]
    names = sorted({k.split()[0] for k in red})
    assert len({k.split()[0] for k in red if k.endswith(" 2x2")}) == \
        len(list_configs()), sorted(red)  # every architecture on (2, 2)
    worst = max(max(v for k, v in r.items() if k != "s")
                for r in red.values())
    print(f"[mesh] (b) {len(red)} cases, {len(names)} architectures "
          f"(reduced, {MESH_LAYERS} layers, f32): 4 ranks == 1 rank "
          f"(prefill logits and caches, a decode step, a train step's loss,"
          f" grad norm and params; worst {worst:.2e}, tolerance "
          f"rtol=atol=2e-3) in {res['reduced']['part_s']:.1f} s",
          flush=True)
    sv = res["serve"]["result"]
    print(f"[mesh] (a) {sv['config']} full width and depth on (data=1, "
          f"model={MESH_RANKS}), {sv['experts_per_rank']} experts a rank, "
          f"bf16: prefill {sv['batch']} x {sv['prompt']} "
          f"{sv['prefill_ms']:.1f} ms warm ({sv['prefill_ms_cold']:.1f} "
          f"cold), decode {sv['decode_ms_per_step']:.1f} ms a step "
          f"({sv['decode_tokens_per_s']:.1f} tokens/s), {sv['ep_calls']} "
          f"expert-parallel MoE calls; params drawn in {sv['init_s']:.1f} s"
          f", {sv['param_bytes_rank0'] / 2**30:.2f} GiB on rank 0; peak "
          "GiB per rank " + ", ".join(f"{g:.2f}" for g in sv["peak_gib"]),
          flush=True)
    tr = res["train"]["result"]
    print(f"[mesh] (c) {tr['config']} full width and depth trained on "
          f"(data=2, model=2), FSDP + TP, {tr['global_batch']} x "
          f"{tr['seq_len']} tokens as {tr['microbatches']} microbatches: "
          + "; ".join(f"{st['s']:.2f} s loss {st['loss']:.4f} grad_norm "
                      f"{st['grad_norm']:.4f}" for st in tr["steps"])
          + f"; {tr['tokens_per_s']:.1f} tokens/s; peak GiB per rank "
          + ", ".join(f"{g:.2f}" for g in tr["peak_gib"]), flush=True)

    # one rank's first step on the same batch and seed
    t0 = time.perf_counter()
    cfg = get_config(MESH_TRAIN_ARCH)
    torch.cuda.empty_cache()
    import tempfile
    with tempfile.TemporaryDirectory() as ckpt:
        tc = TrainConfig(microbatches=MESH_TRAIN_MB, checkpoint_every=10**9,
                         checkpoint_dir=ckpt, seed=args.seed)
        one = Trainer(cfg, tc, global_batch=MESH_TRAIN_BATCH,
                      seq_len=MESH_TRAIN_SEQ, device=DEVICE)
        one.init_or_resume(resume=False)
        loss1 = one.run(1, with_guard=False)["losses"][0]
    del one
    torch.cuda.empty_cache()
    loss4 = tr["steps"][0]["loss"]
    rel = abs(loss4 - loss1) / abs(loss1)
    assert rel < MESH_TRAIN_LOSS_RTOL, (loss4, loss1)
    res["train_one_rank"] = {"loss": loss1, "rel_diff": rel,
                             "s": time.perf_counter() - t0}
    res["seconds"] = time.perf_counter() - t_phase
    res["ranks_s"] = ranks_s
    print(f"[mesh] (c) first loss on 4 ranks {loss4:.5f}, on one rank "
          f"{loss1:.5f} (relative {rel:.2e} < {MESH_TRAIN_LOSS_RTOL}); "
          f"phase {res['seconds']:.1f} s (ranks {ranks_s:.1f} s: d "
          f"{res['ring']['part_s']:.1f}, e {res['ckpt']['part_s']:.1f}, b "
          f"{res['reduced']['part_s']:.1f}, a {res['serve']['part_s']:.1f},"
          f" c {res['train']['part_s']:.1f})", flush=True)
    return res


#: where the smokes phase's traces and results go (``/build/`` is
#: ignored by git)
SMOKES_DIR = ROOT / "build" / "smokes"
NET_TRACE = SMOKES_DIR / "net_trace.json"
#: each part's subprocess limit in seconds (the scripts' own SIGALRM
#: limits sit inside these)
SMOKES_TIMEOUT = {"a": 60, "b": 300, "c": 300, "d": 300, "e": 120}
#: the chaos sweep's seeds on the card: 4 of the CI's 8, for the script's
#: time limit (PERF.md §6)
SMOKES_CHAOS_SEEDS = 4
#: kernels each two-party part must have launched on the card
SMOKES_PATH_KERNELS = ("garble_walk", "eval_walk", "select_labels")


def phase_smokes(args):
    """The port's CI smokes on the card, each a subprocess with its own
    time limit (a nonzero exit, a timeout or a trace finding fails the
    run): (a) ``scripts/trace_check.py`` on the ``net`` phase's trace
    (BERT-base width, wire v2 over ``InProcPipe``); then, at once, (b)
    ``scripts/net_smoke_torch.py --trace`` (two parties over loopback TCP
    and a two-client gateway pass with a kill, d=8, S=4, the reference
    smoke's 40-bit ring) followed by ``trace_check.py`` on its trace; (c)
    ``scripts/chaos_smoke_torch.py`` over ``SMOKES_CHAOS_SEEDS`` seeded
    fault schedules (each seed bit-identical or typed, the bundle
    identity and the error-frame whitelist held); (d)
    ``scripts/smoke_models_torch.py`` (every reduced architecture: a
    forward pass, a train step, a prefill and a decode step); (e)
    ``scripts/lint_torch.py --all`` against the port's baseline. Every
    part has ended before any result is read. (b) and (c) print their
    kernel launches, which must include the walk kernels and label
    select."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    SMOKES_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    scripts = ROOT / "scripts"
    net_trace = SMOKES_DIR / "net_smoke_trace.json"

    def run(key, *argv):
        """Run ``argv`` under the part's limit (``subprocess.run`` kills
        the child at the limit and raises); returns (argv, proc, s)."""
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *map(str, argv)], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=SMOKES_TIMEOUT[key])
        return argv, proc, time.perf_counter() - t0

    def net_then_check():
        first = run("b", scripts / "net_smoke_torch.py", "--device", DEVICE,
                    "--timeout", 240, "--trace", net_trace)
        if first[1].returncode:
            return [first]
        return [first, run("b", scripts / "trace_check.py", net_trace)]

    def check(key, argv, proc, secs):
        tail = proc.stdout.strip().splitlines()[-1:] or [""]
        assert proc.returncode == 0, f"[smokes] ({key}) {argv[0]} exited " \
            f"{proc.returncode}: {proc.stdout[-3000:]} {proc.stderr[-6000:]}"
        res.setdefault(key, {"s": 0.0})["s"] += secs
        print(f"[smokes] ({key}) {Path(argv[0]).name} {secs:.1f} s: "
              f"{tail[0]}", flush=True)
        for line in proc.stdout.splitlines():
            if line.startswith("kernel launches: "):
                got = json.loads(line.split(": ", 1)[1])
                missing = [k for k in SMOKES_PATH_KERNELS if not got[k]]
                assert not missing, f"[smokes] ({key}) launched no {missing}"
                res[key]["launches"] = got
                print(f"[smokes] ({key}) kernel launches {json.dumps(got)}",
                      flush=True)

    res = {}
    check("a", *run("a", scripts / "trace_check.py", NET_TRACE))
    with ThreadPoolExecutor(4) as pool:
        net = pool.submit(net_then_check)
        chaos = pool.submit(run, "c", scripts / "chaos_smoke_torch.py",
                            "--device", DEVICE, "--seeds",
                            SMOKES_CHAOS_SEEDS, "--timeout", 240)
        models = pool.submit(run, "d", scripts / "smoke_models_torch.py",
                             "--device", DEVICE)
        lint = pool.submit(run, "e", scripts / "lint_torch.py", "--all",
                           "--baseline",
                           "src/repro_torch/analysis/baseline.json")
    # the pool has joined every part: none is left running
    for got in net.result():
        check("b", *got)
    check("c", *chaos.result())
    check("d", *models.result())
    check("e", *lint.result())
    assert all("launches" in res[k] for k in "bc"), res
    res["c"]["seeds"] = [line for line in chaos.result()[1].stdout
                         .splitlines() if line.startswith("seed ")]
    for line in res["c"]["seeds"]:
        print(f"[smokes] (c) {line}", flush=True)
    res["seconds"] = time.perf_counter() - t_phase
    print("[smokes] phase {:.1f} s (b to e at once): ".format(
        res["seconds"]) + ", ".join(f"({k}) {res[k]['s']:.1f}"
                                    for k in "abcde"), flush=True)
    return res


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
    ap.add_argument("--train-resume-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-backend", default=MESH_BACKEND,
                    choices=("gloo-staged", "nccl"),
                    help="the mesh phase's backend: four ranks on one card "
                         "over gloo-staged (the default), or one card a "
                         "rank over nccl (needs four cards)")
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
    if args.train_resume_child:
        _resume_child()
        return 0
    if args.mesh_child:
        _mesh_child(args)
        return 0
    t_all = time.perf_counter()
    name, smi = phase_device()
    built = phase_build()
    if args.ntt_only:
        ntt_rows, ntt_err = phase_kernels_ntt(args)
        big_rows, big_err, keygen = phase_ntt_large(args)
        if args.json is not None:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps({
                "device": name, "nvidia_smi": smi, "build": built,
                "ntt": ntt_rows + big_rows, "keygen_16384": keygen,
                "max_abs_err": max(ntt_err, big_err),
                "total_s": time.perf_counter() - t_all}, indent=1,
                default=float))
        print(f"[done] {time.perf_counter() - t_all:.1f} s")
        return 0
    def lap(phase):
        print(f"[time] {phase} done at {time.perf_counter() - t_all:.1f} s",
              flush=True)

    krows, g_eval, g_garble = phase_kernels(args)
    ntt_rows, ntt_err = phase_kernels_ntt(args)
    big_rows, big_err, keygen = phase_ntt_large(args)
    hg_rows, ls_rows, gate_err = phase_kernels_gates(args, g_eval)
    lap("kernels")
    parity = phase_parity(args)
    gates = phase_gates(args, g_eval)
    he = phase_he(args)
    lap("parity, gates, he")
    serve, engine, x0, serve_ys = phase_serve(args)
    walks = phase_walks(engine, args)
    prof = phase_profile(engine, x0, args.seq)
    del engine
    lap("serving, walks, profile")
    net, model, xs, shared = phase_net(args, serve, serve_ys)
    lap("net")
    gateway = phase_gateway(args, model, xs, shared, serve_ys)
    del model, shared
    lap("gateway")
    eager = phase_eager(args, serve_ys)
    lap("eager")
    model = phase_model(args)
    lap("model")
    train = phase_train(args)
    lap("train")
    mesh = phase_mesh(args)
    lap("mesh")
    smokes = phase_smokes(args)
    lap("smokes")

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
            "timing": row["timing"], "ms_warm": row["ms_warm"],
            "timing_warm": row["timing_warm"],
            "cold_buffers": row["cold_buffers"]})
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
        "launches": serve["launches"]["ntt"],
        "max_abs_err": max(ntt_err, big_err),
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": None, "rows": fwd["rows"], "n": fwd["n"],
        "call_ms": fwd["call_ms"], "timing": fwd["timing"],
        "ms_warm": fwd["ms_warm"],
        "inverse_ms": inv["ms"], "inverse_ms_warm": inv["ms_warm"],
        "inverse_plain_ms": inv["plain_ms"],
        "inverse_bound_ms": inv["bound_ms"],
        "launches_he_phase": he["launches"],
        "keygen_16384": keygen,
        "shapes": [{k: r[k] for k in ("shape", "rows", "ms", "ms_warm",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "timing", "timing_warm",
                                      "launches_per_call")}
                   for r in ntt_rows + big_rows]})
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
            "timing": row["timing"], "ms_warm": row["ms_warm"],
            "timing_warm": row["timing_warm"],
            "cold_buffers": row["cold_buffers"]})
    # launches on the later slices' paths: the two-party run, the eager
    # path and the gateway
    for k in kernels:
        k["launches_net"] = net["launches"].get(k["name"], 0)
        k["launches_eager"] = eager["launches"].get(k["name"], 0)
        k["launches_gateway"] = gateway["launches"].get(k["name"], 0)
    total = time.perf_counter() - t_all
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({
            "device": name, "nvidia_smi": smi, "build": built,
            "kernels": {str(g): r for g, r in krows.items()},
            "ntt": ntt_rows + big_rows, "keygen_16384": keygen,
            "halfgate": hg_rows, "label_select": ls_rows,
            "parity": parity, "gates": gates,
            "he": he, "serve": serve, "walks": walks,
            "profile": prof, "net": net, "gateway": gateway,
            "eager": eager, "model": model, "train": train, "mesh": mesh,
            "smokes": smokes, "total_s": total}, indent=1,
            default=float))
    print(f"[done] {total:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
