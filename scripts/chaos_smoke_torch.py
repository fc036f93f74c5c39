"""Chaos smoke of the PyTorch port: seeded fault schedules against a
resilient client on a loopback-TCP PitGateway. Every seed must either
complete bit-identical to the in-process session or fail with a typed
error — no hangs (SIGALRM hard limit), no bundle reuse (the prepped ==
consumed + outstanding + returned + burned identity is checked after
every seed), and no secret bytes on error/CONTROL frames (class-name-only
audit of everything that crossed a faulty transport). The counterpart of
``scripts/chaos_smoke.py``, with the same model, schedules and checks, on
``repro_torch``.

    PYTHONPATH=src python scripts/chaos_smoke_torch.py [--device cuda] \\
        [--seeds 8] [--timeout 360]

``--device`` defaults to ``cuda`` and raises when no card is there; pass
``cpu`` to run the kernels' plain versions.
"""

import argparse
import json
import re
import signal
import sys
import time

#: error CONTROL frames carry a class name plus a fixed parenthetical,
#: never str(e) / payload bytes / tracebacks (the secretflow discipline)
ERROR_WHITELIST = re.compile(
    r"^[A-Za-z_][A-Za-z0-9_]* \((idle deadline exceeded|"
    r"request deadline exceeded|see evaluator-side log)\)$")

ALLOWED = {"ok", "BundlePoolEmpty", "TransportClosed", "TransportTimeout",
           "SessionLost"}

D, HEADS, DFF, S = 8, 2, 16, 4
PCFG = dict(he_poly_n=256, he_num_primes=3, he_t_bits=40, frac_bits=6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the parties garble and evaluate on")
    ap.add_argument("--seeds", type=int, default=8,
                    help="number of seeded fault schedules to sweep")
    ap.add_argument("--timeout", type=int, default=360,
                    help="hard wall-clock limit (SIGALRM) in seconds")
    args = ap.parse_args(argv)

    def die(signum, frame):
        print(f"FAIL: chaos smoke exceeded {args.timeout}s — a faulted "
              f"session hung instead of failing typed", flush=True)
        sys.stdout.flush()
        import os

        os._exit(2)

    signal.signal(signal.SIGALRM, die)
    signal.alarm(args.timeout)

    import numpy as np
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass "
                           f"--device cpu to run on the CPU")

    from repro_torch.config import PrivacyConfig
    from repro_torch.core.engine import PrivateTransformer, random_weights
    from repro_torch.kernels import launch_counts
    from repro_torch.net import (Deadlines, FaultPlan, ResilientClient,
                                 RetryPolicy, TcpListener, TcpTransport,
                                 TransportClosed)
    from repro_torch.net import wire as W
    from repro_torch.serve import BundlePoolEmpty, PitGateway

    dev = args.device
    rng = np.random.default_rng(0)
    weights = random_weights(rng, D, DFF, 1)
    pcfg = PrivacyConfig(**PCFG)
    model = PrivateTransformer(pcfg, D, HEADS, DFF, weights, seed=0,
                               device=dev)
    x = rng.normal(0, 1, (S, D))
    sess = model.compile_session(S)
    y_ref = sess.run(x, sess.preprocess(1)[0])
    dl = Deadlines.uniform(20.0)

    t0 = time.perf_counter()
    violations = []
    outcomes = {}
    for seed in range(args.seeds):
        gw = PitGateway(model, S, device=dev, max_sessions=4, pool_cap=4,
                        lease_s=30.0)
        lst = TcpListener()
        loop = gw.serve_listener(lst, accept_timeout=0.1, deadlines=dl)
        plan = FaultPlan(seed=seed, faulty_conns=2, n_faults=1,
                         first_op=2, horizon=40, stall_s=0.05,
                         record_frames=True)
        port = lst.port
        cli = ResilientClient(
            lambda: plan.wrap(TcpTransport.connect("127.0.0.1", port)),
            seed=seed, device=dev,
            policy=RetryPolicy(attempts=6, base_s=0.01, max_s=0.05,
                               seed=seed),
            deadlines=dl)
        t_seed = time.perf_counter()
        try:
            cli.preprocess(1)
            y = cli.run(x)
            outcome = "ok" if np.array_equal(y, y_ref) else "DIVERGED"
        except BundlePoolEmpty:
            outcome = "BundlePoolEmpty"
        except TransportClosed as e:
            outcome = type(e).__name__
        except Exception as e:  # untyped escape = a resilience bug
            outcome = f"UNTYPED:{type(e).__name__}"
        finally:
            try:
                cli.close()
            except (TransportClosed, OSError):
                pass
        outcomes[seed] = outcome
        if outcome not in ALLOWED:
            violations.append(f"seed {seed}: outcome {outcome}")

        st = gw.stats()
        if st["bundles_prepped"] != (st["bundles_consumed"]
                                     + st["bundles_outstanding"]
                                     + st["bundles_returned"]
                                     + st["bundles_burned"]):
            violations.append(f"seed {seed}: bundle identity violated "
                              f"({st['bundles_prepped']} prepped != "
                              f"{st['bundles_consumed']}c + "
                              f"{st['bundles_outstanding']}o + "
                              f"{st['bundles_returned']}r + "
                              f"{st['bundles_burned']}b)")
        audited = 0
        for ft in plan.transports:
            for _direction, fr in ft.frame_log:
                try:
                    msg = W.decode_frame(fr)
                except Exception:
                    continue  # torn frames are undecodable by design
                if msg.kind != W.KIND_CONTROL:
                    continue
                audited += 1
                if msg.tag == "error" and not (
                        isinstance(msg.payload, str)
                        and ERROR_WHITELIST.match(msg.payload)):
                    violations.append(
                        f"seed {seed}: non-whitelisted error frame")
        faults = ["%s@%d.%d" % (k, c, o) for c, o, k in plan.injected()]
        print(f"seed {seed}: {outcome} in "
              f"{time.perf_counter() - t_seed:.1f}s "
              f"(faults {','.join(faults) or 'none'}, "
              f"reconnects {cli.stats()['reconnects']}, "
              f"burned {st['bundles_burned']}, resumed "
              f"{st['sessions_resumed']}, {audited} frames audited)",
              flush=True)
        loop.stop()
        gw.close()
        lst.close()
        # a retired endpoint may still be walking: let it reach its next
        # transport op and exit before the next seed (and the interpreter)
        for th in gw.threads:
            th.join(timeout=60)

    n_ok = sum(1 for v in outcomes.values() if v == "ok")
    if n_ok == 0:
        violations.append("no seed completed — the sweep proved nothing")
    print(f"kernel launches: {json.dumps(launch_counts())}", flush=True)
    if violations:
        print("FAIL: " + "; ".join(violations), flush=True)
        return 1
    print(f"chaos smoke OK in {time.perf_counter() - t0:.1f}s: "
          f"{args.seeds} seeded schedules, {n_ok} bit-identical, "
          f"{args.seeds - n_ok} typed failures, identity + frame "
          f"hygiene held on every seed", flush=True)
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
