#!/usr/bin/env python3
"""Which collectives the ``gloo`` backend takes on CUDA tensors.

    python3 scripts/gloo_cuda_probe.py [--device cuda|cpu] [--ranks 4]
        [--backend gloo|gloo-staged ...] [--json PATH]

Starts ``--ranks`` processes with ``torch.distributed.run`` on one host,
every rank on the same device (``cuda:0`` when ``--device cuda``: NCCL
refuses two ranks on one GPU, gloo does not), and tries each collective
the port's multi-rank plane uses, through the ``c10d`` calls and through
DTensor redistributes on a ``DeviceMesh`` of that device type. For each
it records whether the call ran, whether the result was right, its error
if it raised, and its wall time for a 4 MiB f32 tensor. ``gloo-staged``
is the port's gloo with host staging (``repro_torch.launch.mesh``), for
the check that it takes every collective. Each collective
runs in a launch of its own: gloo aborts the process (``writev ... Bad
address``) when it hands a device pointer to its TCP transport, and that
must not hide the collectives after it. Rank 0 prints one JSON line per
launch; the parent prints the table.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"

C10D = ("all_reduce", "broadcast", "all_gather_into_tensor", "all_gather",
        "reduce_scatter_tensor", "all_to_all_single", "batch_isend_irecv",
        "batch_isend_irecv_int8")
DTENSOR = ("shard_to_replicate", "partial_to_replicate", "partial_to_shard",
           "shard0_to_shard1", "matmul_shard_x_shard")


def _probe(backend: str, device: str, kind: str, name: str) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import init_ranks, p2p_exchange

    dev = init_ranks(backend, device=device, timeout_s=60)
    rank, n = dist.get_rank(), dist.get_world_size()
    numel = 1 << 20  # 4 MiB of f32

    def full(v, m=numel):
        return torch.full((m,), float(v), device=dev)

    def p2p_ring(t):
        out = torch.empty_like(t)
        if backend == "gloo-staged":  # the port's staged exchange
            return p2p_exchange(t, (rank + 1) % n, out, (rank - 1) % n)
        ops = [dist.P2POp(dist.isend, t, (rank + 1) % n),
               dist.P2POp(dist.irecv, out, (rank - 1) % n)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return out

    def c10d(name):
        if name == "all_reduce":
            t = full(rank + 1)
            dist.all_reduce(t)
            return bool((t == n * (n + 1) / 2).all())
        if name == "broadcast":
            t = full(rank)
            dist.broadcast(t, 0)
            return bool((t == 0).all())
        if name == "all_gather_into_tensor":
            out = torch.empty(n * numel, device=dev)
            dist.all_gather_into_tensor(out, full(rank))
            want = torch.arange(n, device=dev).repeat_interleave(numel)
            return bool((out == want).all())
        if name == "all_gather":
            outs = [torch.empty(numel, device=dev) for _ in range(n)]
            dist.all_gather(outs, full(rank))
            return all(bool((o == i).all()) for i, o in enumerate(outs))
        if name == "reduce_scatter_tensor":
            out = torch.empty(numel // n, device=dev)
            dist.reduce_scatter_tensor(out, full(1))
            return bool((out == n).all())
        if name == "all_to_all_single":
            src = torch.arange(n, device=dev, dtype=torch.float32
                               ).repeat_interleave(numel // n) + 10 * rank
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src)
            want = (torch.arange(n, device=dev, dtype=torch.float32) * 10
                    + rank).repeat_interleave(numel // n)
            return bool((out == want).all())
        if name == "batch_isend_irecv":
            return bool((p2p_ring(full(rank)) == (rank - 1) % n).all())
        if name == "batch_isend_irecv_int8":
            t = torch.full((numel,), rank, dtype=torch.int8, device=dev)
            return bool((p2p_ring(t) == (rank - 1) % n).all())
        raise ValueError(name)

    mesh = DeviceMesh(dev.type, list(range(n)), mesh_dim_names=("model",))
    rows = 4 * n

    def dtensor(name):
        g = torch.arange(rows * 8, dtype=torch.float32, device=dev
                         ).reshape(rows, 8)
        if name == "shard_to_replicate":
            d = DTensor.from_local(g.chunk(n)[rank], mesh, [Shard(0)])
            return torch.equal(d.redistribute(mesh, [Replicate()])
                               .to_local(), g)
        if name == "partial_to_replicate":
            d = DTensor.from_local(g, mesh, [Partial()])
            return torch.equal(d.redistribute(mesh, [Replicate()])
                               .to_local(), g * n)
        if name == "partial_to_shard":
            d = DTensor.from_local(g, mesh, [Partial()])
            return torch.equal(d.redistribute(mesh, [Shard(0)]).to_local(),
                               (g * n).chunk(n)[rank])
        if name == "shard0_to_shard1":
            d = DTensor.from_local(g.chunk(n)[rank], mesh, [Shard(0)])
            return torch.equal(d.redistribute(mesh, [Shard(1)]).to_local(),
                               g.chunk(n, 1)[rank])
        if name == "matmul_shard_x_shard":
            a = DTensor.from_local(g.chunk(n, 1)[rank], mesh, [Shard(1)])
            b = DTensor.from_local(g.t().chunk(n)[rank], mesh, [Shard(0)])
            return torch.allclose((a @ b).full_tensor(), g @ g.t())
        raise ValueError(name)

    fn = c10d if kind == "c10d" else dtensor
    rec = {"rank": rank, "world": n, "device": str(dev), "backend": backend,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "kind": kind, "name": name}
    for rep in range(2):  # the second call is the timed one
        dist.barrier()
        t0 = time.perf_counter()
        try:
            ok = fn(name)
            if device == "cuda":
                torch.cuda.synchronize()
            rec.update(ran=True, right=ok,
                       ms=1e3 * (time.perf_counter() - t0))
        # a probe: every refusal is the result being recorded
        except Exception as e:  # noqa: BLE001
            rec.update(ran=False, error=f"{type(e).__name__}: "
                       f"{str(e).splitlines()[0][:200]}")
            break
    dist.barrier()
    dist.destroy_process_group()
    return rec


def _launch(args, backend, kind, name) -> dict:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={args.ranks}", os.path.abspath(__file__),
           "--device", args.device, "--backend", backend,
           "--child", f"{kind}/{name}"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    lines = [ln[6:] for ln in proc.stdout.splitlines()
             if ln.startswith("PROBE ")]
    if lines:
        rec = json.loads(lines[-1])
    else:
        what = [ln.strip() for ln in proc.stderr.splitlines()
                if "what()" in ln or "Error:" in ln or "error:" in ln]
        rec = {"ran": False, "crashed": True,
               "error": (what[0] if what else "no output")[:300],
               "stderr_tail": proc.stderr[-3000:]}
    rec["returncode"] = proc.returncode
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", nargs="+", default=["gloo"],
                    choices=("gloo", "gloo-staged"))
    ap.add_argument("--only", nargs="*", default=None,
                    help="kind/name of the collectives to try (all if unset)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        rec = _probe(args.backend[0], args.device, *args.child.split("/"))
        if rec["rank"] == 0:
            print("PROBE " + json.dumps(rec), flush=True)
        return 0
    import torch

    res = {"device": args.device, "ranks": args.ranks,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    for backend in args.backend:
        res[backend] = {"c10d": {}, "dtensor": {}}
        print(f"{backend}, {args.ranks} ranks on one {args.device} device "
              f"(torch {res['torch']}, CUDA {res['cuda']}):", flush=True)
        for kind, names in (("c10d", C10D), ("dtensor", DTENSOR)):
            for name in names:
                if args.only and f"{kind}/{name}" not in args.only:
                    continue
                rec = _launch(args, backend, kind, name)
                res[backend][kind][name] = rec
                state = (f"ran, right={rec['right']}, {rec['ms']:.2f} ms"
                         if rec["ran"] else
                         ("crashed: " if rec.get("crashed") else "refused: ")
                         + rec["error"])
                print(f"  {kind:8s} {name:24s} {state}", flush=True)
                if rec.get("crashed"):
                    print(rec["stderr_tail"], flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
