"""End-to-end driver of the PyTorch/CUDA port (``repro_torch``): serve a
(reduced) BERT-style encoder privately with the compile → preprocess → run
lifecycle — the paper's deployment scenario. It mirrors
``examples/serve_private_bert.py``; garbling and evaluation run on
``--device`` (``cuda`` by default, ``cpu`` for the kernels' plain
versions).

The server owns the weights, each client owns its input embeddings. The
engine compiles one ``PiTSession`` per sequence-length bucket, runs ALL
offline work (garbling, HE mask products, Beaver triples) for a whole
batch of future requests in one preprocessing pass, then serves every
request online-only from the bundle pool. The offline/online latency and
communication tables come straight from the session's phase ledgers — the
phase boundary itself, not accumulated timer deltas.

``--net pipe|tcp`` runs the same deployment as an actual **two-party
exchange** (``repro_torch.net``): a ``PitNetServer`` hosts the weights behind a
dedicated offline endpoint pair and an online pair; the client garbles,
streams tables/HE frames over the wire, and serves requests with bundle
refill pipelined against online traffic. Wire frames carry the metered
``Channel`` sizes by construction; byte-equality with the in-process
oracle is *asserted* in ``tests/test_torch_net.py``.

    PYTHONPATH=src python examples/serve_private_bert_torch.py [--requests 3]
    PYTHONPATH=src python examples/serve_private_bert_torch.py --net tcp
    PYTHONPATH=src python examples/serve_private_bert_torch.py \
        --device cpu --d 8 --seq 4

``--trace PATH`` records the whole serve (compile/preprocess/run spans,
per-op protocol spans, wire send/recv and the ``net.d2h``/``net.h2d``
copies when ``--net``) with ``repro_torch.obs`` and exports a Chrome
trace_event JSON plus a per-span-path summary.
"""

import argparse
from time import perf_counter

import numpy as np

from repro_torch import obs
from repro_torch.config import PrivacyConfig
from repro_torch.core.engine import PrivateTransformer, random_weights
from repro_torch.serve import PrivateRequest, PrivateServeEngine


def serve_in_process(model, args, rng):
    engine = PrivateServeEngine(model, buckets=(args.seq,),
                                pool_target=args.requests,
                                device=args.device)

    # ---- offline: one preprocessing batch for the whole request wave ----
    t0 = perf_counter()
    level = engine.preprocess(args.seq, args.requests)
    t_pre = perf_counter() - t0
    print(f"preprocess: {args.requests} bundles in {t_pre:6.1f}s "
          f"(pool level {level})")

    # ---- online: every request served from the same preprocessing batch -
    requests = [
        PrivateRequest(x=rng.normal(0, 1, (args.seq, args.d)))
        for _ in range(args.requests)
    ]
    for i, r in enumerate(requests):
        t0 = perf_counter()
        engine.serve([r])
        dt = perf_counter() - t0
        err = np.abs(r.result - model.forward_float(r.x)).max()
        print(f"request {i}: online {dt:6.1f}s  max|priv-float|={err:.4f}")

    st = engine.stats(args.seq)
    print("\n--- phase ledger (from the session phase boundary) ---")
    print(f"offline: {st.offline.channel.total / 1e6:8.2f} MB "
          f"in {st.offline.t_s:6.1f}s "
          f"(LAN model: {st.offline.channel.time_s():.2f}s)")
    print(f"online : {st.online.channel.total / 1e6:8.2f} MB "
          f"in {st.online.t_s:6.1f}s "
          f"(LAN model: {st.online.channel.time_s():.2f}s)")
    print(f"GC work: {st.gc_instances_ands:.3e} AND evaluations")
    for name, v in st.per_fn.items():
        print(f"  {name:26s} and/inst={v['and']:>7d} instances={v['instances']}")


def serve_two_party(model, args, rng):
    """The same wave over real endpoints: pipelined offline/online pairs."""
    from repro_torch.net import (InProcPipe, PitNetServer, TcpListener,
                                 TcpTransport)
    from repro_torch.serve import NetPrivateServeEngine

    srv = PitNetServer(model, args.seq, device=args.device)
    if args.net == "tcp":
        lst = TcpListener()
        loop = srv.serve_tcp(lst, timeout=600, max_conns=2)
        off_c = TcpTransport.connect("127.0.0.1", lst.port)
        on_c = TcpTransport.connect("127.0.0.1", lst.port)
        loop.wait_accepted(2, timeout=60)
        print(f"two-party over loopback TCP (port {lst.port})")
    else:
        off_c, off_s = InProcPipe.make_pair()
        on_c, on_s = InProcPipe.make_pair()
        srv.serve_transport(off_s, timeout=600, name="pit-eval-offline")
        srv.serve_transport(on_s, timeout=600, name="pit-eval-online")
        print("two-party over InProcPipe")

    eng = NetPrivateServeEngine(off_c, on_c, pool_target=args.requests,
                                seed=1, device=args.device, timeout=600)
    t0 = perf_counter()
    eng.preprocess(args.requests)
    t_pre = perf_counter() - t0
    print(f"preprocess (wire): {args.requests} bundles in {t_pre:6.1f}s "
          f"(pool level {eng.pool_size()})")

    refill = eng.refill_async(1)  # pipelined: streams while we serve
    for i in range(args.requests):
        x = rng.normal(0, 1, (args.seq, args.d))
        t0 = perf_counter()
        y = eng.run(x)
        dt = perf_counter() - t0
        err = np.abs(y - model.forward_float(x)).max()
        print(f"request {i}: online {dt:6.1f}s  max|priv-float|={err:.4f}  "
              f"refill-in-flight={refill.is_alive()}")
    refill.join(timeout=600)

    led = eng.ledger
    print("\n--- wire ledger (PROTO payloads at metered-oracle sizes) ---")
    print(f"offline: {led.offline.total / 1e6:8.2f} MB "
          f"(LAN model: {led.offline.time_s():.2f}s)")
    print(f"online : {led.online.total / 1e6:8.2f} MB "
          f"(LAN model: {led.online.time_s():.2f}s)")
    print(f"overhead: sim sideband {led.sim_bytes / 1e6:.2f} MB, control "
          f"{led.control_bytes / 1e3:.1f} KB, dir flips {led.dir_flips}")
    eng.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--no-offload", action="store_true",
                    help="PRIMER-style baseline (full LayerNorm in GC)")
    ap.add_argument("--net", choices=("off", "pipe", "tcp"), default="off",
                    help="off: in-process session; pipe/tcp: real two-party "
                         "endpoints with pipelined offline/online pairs")
    ap.add_argument("--device", default="cuda",
                    help="where garbling and evaluation run (cuda or cpu)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="export a Chrome trace_event JSON of the serve")
    args = ap.parse_args()

    if args.trace:
        obs.enable()

    rng = np.random.default_rng(1)
    weights = random_weights(rng, args.d, 2 * args.d, args.layers)
    pcfg = PrivacyConfig(
        he_poly_n=256, he_num_primes=3, he_t_bits=40, frac_bits=7,
        layernorm_offload=not args.no_offload,
    )
    model = PrivateTransformer(pcfg, args.d, 2, 2 * args.d, weights, seed=0,
                               device=args.device)
    print(f"server up: d={args.d} layers={args.layers} "
          f"LN-offload={not args.no_offload} t={model.p.t} "
          f"gc_word={model.p.k}b  bucket S={args.seq}\n")

    if args.net == "off":
        serve_in_process(model, args, rng)
    else:
        serve_two_party(model, args, rng)

    if args.trace:
        tr = obs.current()
        tr.export(args.trace)
        print(f"\n--- trace: {len(tr.finished_spans())} spans -> "
              f"{args.trace} ---")
        for path, agg in tr.report().items():
            print(f"  {path:44s} n={agg['count']:<4d} "
                  f"total={agg['total_s']:.3f}s mean={agg['mean_s']:.4f}s")


if __name__ == "__main__":
    main()
