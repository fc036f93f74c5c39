"""Smoke of the PyTorch port's two-party runtime: GarblerEndpoint ↔
EvaluatorEndpoint end to end over loopback TCP on a tiny model, plus a
multi-client PitGateway pass (two sessions, one killed mid-session),
under a hard timeout so a deadlocked socket fails fast instead of
hanging. The counterpart of ``scripts/net_smoke.py``, with the same
model and checks, on ``repro_torch``.

    PYTHONPATH=src python scripts/net_smoke_torch.py [--device cuda] \\
        [--timeout 180] [--trace trace.json]

``--device`` defaults to ``cuda`` and raises when no card is there; pass
``cpu`` to run the kernels' plain versions. ``--trace PATH`` records the
whole smoke (both parties and the gateway pass) with ``repro_torch.obs``
and exports a Chrome trace_event JSON for ``scripts/trace_check.py``.
``model_and_input`` and ``two_party`` are the smoke's model and its
two-party leg, importable on their own.
"""

import argparse
import json
import signal
import sys
import time

D, HEADS, DFF, S = 8, 2, 16, 4
PCFG = dict(he_poly_n=256, he_num_primes=3, he_t_bits=40, frac_bits=6)


def model_and_input(device):
    """The smoke's model and input, drawn from ``np.random.default_rng(0)``
    in the reference smoke's order (weights, then the input)."""
    import numpy as np

    from repro_torch.config import PrivacyConfig
    from repro_torch.core.engine import PrivateTransformer, random_weights

    rng = np.random.default_rng(0)
    weights = random_weights(rng, D, DFF, 1)
    model = PrivateTransformer(PrivacyConfig(**PCFG), D, HEADS, DFF,
                               weights, seed=0, device=device)
    return model, rng.normal(0, 1, (S, D))


def two_party(model, x, device):
    """The two-party leg: a ``PitNetServer`` behind ``serve_tcp`` and a
    ``GarblerEndpoint`` over loopback TCP, one bundle and one run. Returns
    the revealed output, the negotiated wire version and the garbler's
    ledger summary (read before the bye)."""
    from repro_torch.net import GarblerEndpoint, PitNetServer, TcpListener, \
        TcpTransport

    srv = PitNetServer(model, S, device=device)
    lst = TcpListener()
    loop = srv.serve_tcp(lst, timeout=120)
    cli = GarblerEndpoint(TcpTransport.connect("127.0.0.1", lst.port),
                          seed=7, device=device, timeout=120)
    assert loop.wait_accepted(1, timeout=30), "server never accepted"
    cli.preprocess(1)
    y = cli.run(x)
    out = {"y": y, "negotiated_version": cli.shared.negotiated_version,
           "ledger": cli.shared.ledger.summary()}
    cli.close()
    loop.stop()
    lst.close()
    srv.join(timeout=60)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the parties garble and evaluate on")
    ap.add_argument("--timeout", type=int, default=180,
                    help="hard wall-clock limit (SIGALRM) in seconds")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="export a Chrome trace_event JSON of the smoke")
    args = ap.parse_args(argv)

    def die(signum, frame):
        print(f"FAIL: net smoke exceeded {args.timeout}s — deadlocked "
              f"socket or runaway exchange", flush=True)
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

    from repro_torch import obs
    from repro_torch.kernels import launch_counts

    if args.trace:
        obs.enable()

    dev = args.device
    model, x = model_and_input(dev)
    t0 = time.perf_counter()
    leg = two_party(model, x, dev)
    y = leg["y"]

    sess = model.compile_session(S, wire_version=2)
    y_ref = sess.run(x, sess.preprocess(1)[0])
    assert np.array_equal(y, y_ref), "wire output != in-process session"
    assert leg["negotiated_version"] == 2, "hello did not land on v2"
    lsum = leg["ledger"]
    st = sess.stats
    assert lsum["offline_by_tag"] == dict(st.channel_offline.by_tag), \
        "offline wire ledger != metered oracle"
    assert lsum["online_by_tag"] == dict(st.channel_online.by_tag), \
        "online wire ledger != metered oracle"
    assert lsum["rounds_after_coalescing"] < lsum["raw_messages"], \
        "v2 coalescing did not reduce the wire round count"
    err = float(np.abs(y - model.forward_float(x)).max())
    assert err < 0.25, f"accuracy drifted: {err}"

    print(f"net smoke OK in {time.perf_counter() - t0:.1f}s: loopback-TCP "
          f"wire v2 output bit-identical, ledger == oracle "
          f"({lsum['offline_bytes'] / 1e6:.1f} MB offline / "
          f"{lsum['online_bytes'] / 1e6:.2f} MB online, "
          f"{lsum['rounds_after_coalescing']} coalesced rounds vs "
          f"{lsum['raw_messages']} metered msgs), max|err|={err:.4f}",
          flush=True)

    # -- gateway: 2 concurrent sessions behind one accept loop, one
    # killed mid-session with a bundle outstanding --------------------
    from repro_torch.net import TcpListener
    from repro_torch.serve import PitGateway, gateway_client

    t1 = time.perf_counter()
    gw = PitGateway(model, S, device=dev, max_sessions=4, pool_cap=4)
    glst = TcpListener()
    gloop = gw.serve_listener(glst, accept_timeout=0.2, timeout=120)
    e1 = gateway_client("127.0.0.1", glst.port, seed=1, device=dev,
                        timeout=120)
    e2 = gateway_client("127.0.0.1", glst.port, seed=2, device=dev,
                        timeout=120)
    e1.preprocess(2)  # one to run, one to strand on the kill
    e2.preprocess(1)
    assert np.array_equal(e1.run(x), y_ref), "gateway session 1 diverged"
    e1.offline.transport.close()  # kill: no bye, bundle outstanding
    e1.online.transport.close()
    deadline = time.monotonic() + 30
    while gw.stats()["sessions_active"] != 1:
        assert time.monotonic() < deadline, "victim session never reclaimed"
        time.sleep(0.05)
    assert np.array_equal(e2.run(x), y_ref), "survivor session diverged"
    gst = gw.stats()
    assert gst["bundles_returned"] == 1, gst["bundles_returned"]
    cache = gst["garbling_cache"]
    e2.close()
    gloop.stop()
    gw.close()
    glst.close()
    for th in gw.threads:
        th.join(timeout=60)
    print(f"gateway smoke OK in {time.perf_counter() - t1:.1f}s: "
          f"2 sessions muxed, mid-session kill returned "
          f"{gst['bundles_returned']} bundle, shared cache "
          f"{cache['slabs']} slabs / {cache['hits']} hits", flush=True)
    print(f"kernel launches: {json.dumps(launch_counts())}", flush=True)
    if args.trace:
        tr = obs.current()
        tr.export(args.trace)
        rep = tr.report()
        print(f"trace: {len(tr.finished_spans())} spans / "
              f"{len(rep)} span paths -> {args.trace}", flush=True)
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
