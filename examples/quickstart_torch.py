"""Quickstart of the PyTorch/CUDA port: the APINT privacy plane in ~60
lines, as ``examples/quickstart.py`` runs it, with garbling and evaluation
on ``--device`` (``cuda`` by default; ``cpu`` runs the kernels' plain
versions).

1. Build a GC-friendly circuit (i-BERT softmax row) and inspect the XFBQ
   AND-gate savings.
2. Run it privately: secret-share a row, garble (client), evaluate
   (server), reveal — and check against the cleartext softmax.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.config import PrivacyConfig
from repro_torch.core import secret_sharing as SS
from repro_torch.core.circuits import nonlinear as NL
from repro_torch.core.protocol import PiTProtocol


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where garbling and evaluation run (cuda or cpu)")
    args = ap.parse_args()

    # --- circuit generation (§3.2) -------------------------------------
    for style in ("conventional", "xfbq"):
        net = NL.softmax_circuit(8, k=37, frac=12, style=style).build()
        print(f"softmax8 [{style:12s}]  AND={net.and_count:7d} "
              f"XOR={net.xor_count:7d} depth={net.stats()['depth']}")

    # --- private evaluation (the APINT protocol) ------------------------
    pcfg = PrivacyConfig(he_poly_n=256, he_num_primes=3, he_t_bits=40,
                         frac_bits=6)
    proto = PiTProtocol(pcfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)

    rows = rng.normal(0.0, 1.5, (4, 8))  # four independent rows (coarse-
    # grained instances: one per accelerator core / data-parallel shard)
    enc = SS.encode_fx(rows, 2 * proto.frac, proto.t)
    client_share, server_share = SS.share(rng, enc, proto.t)

    oc, os_ = proto.softmax_rows(client_share, server_share, 8,
                                 in_scale=2 * proto.frac)
    got = proto.reveal(oc, os_)
    want = np.exp(rows - rows.max(1, keepdims=True))
    want /= want.sum(1, keepdims=True)

    print(f"\nprivate softmax max|err| = {np.abs(got - want).max():.4f}")
    st = proto.stats
    print(f"GC: {st.gc_instances_ands} AND-gate evaluations "
          f"({st.gc_and_gates} per instance x 4 rows)")
    print(f"offline comm {st.channel_offline.total / 1e6:.2f} MB "
          f"(tables + labels + HE), online {st.channel_online.total / 1e3:.1f} KB (OT)")
    assert np.abs(got - want).max() < 0.05
    print("OK")


if __name__ == "__main__":
    main()
