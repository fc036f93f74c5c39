"""Multi-pod dry-run: the layout, memory and roofline report of every
(arch × shape × mesh) cell.

The port of what ``src/repro/launch/dryrun.py`` reports that maps onto a
``torch.distributed`` job, computed on an ``AbstractMesh`` (axis names
and sizes, no process group), so the 256- and 512-rank production meshes
need no ranks:

  * the sharding rules of the cell (``make_rules``);
  * every leaf of the step's inputs (train state, or serving params,
    batch and decode caches) with its spec and per-rank shard shape (the
    reference's ``NamedSharding.shard_shape``) and per-rank bytes;
  * the analytic HBM traffic (``roofline/analytic.traffic``), the model
    FLOPs and the roofline terms from them.

What the reference reads out of XLA has no counterpart here, since the
port compiles no program for a mesh: ``cost_analysis`` FLOPs and bytes,
the temporaries of ``memory_analysis``, the HLO collective and
trip-count accounting (``hlo_costs.analyze_hlo``,
``parse_collectives``) and lower/compile times. The roofline's
collective term therefore is 0 here (``"collective": "not modeled"``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
        --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Each cell writes ``<arch>__<shape>__<pod|multipod>.json``, the
reference's naming.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback

import torch

from repro_torch.config import TrainConfig, assigned_shapes, get_config
from repro_torch.config.base import SHAPES_BY_NAME
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (abstract_state, serve_param_struct,
                                      state_shardings)
from repro_torch.models.sharding import make_rules, named_sharding_tree
from repro_torch.roofline.analysis import model_flops, roofline_terms
from repro_torch.roofline.analytic import traffic as analytic_traffic

ASSIGNED = [
    "olmoe-1b-7b",
    "llama4-scout-17b-a16e",
    "llama3.2-1b",
    "deepseek-67b",
    "qwen3-1.7b",
    "smollm-360m",
    "musicgen-medium",
    "xlstm-125m",
    "zamba2-2.7b",
    "internvl2-26b",
]

# gradient-accumulation factors of the train_4k cells (the reference's)
TRAIN_MICROBATCHES = {
    "deepseek-67b": 8,
    "llama4-scout-17b-a16e": 4,
    "internvl2-26b": 4,
    "zamba2-2.7b": 4,
    "olmoe-1b-7b": 2,
    "xlstm-125m": 2,
    "musicgen-medium": 2,
}


def _leaves(tree, shardings, prefix=""):
    """(path, struct, sharding) for every tensor leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, shardings[k], f"{prefix}/{k}")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree, shardings


def _layout(tree, shardings) -> dict:
    out, total = {}, 0
    for path, st, sh in _leaves(tree, shardings):
        local = sh.shard_shape(tuple(st.shape))
        nbytes = math.prod(local) * st.element_size()
        total += nbytes
        out[path] = {"shape": list(st.shape), "dtype": str(st.dtype)[6:],
                     "spec": [list(e) if isinstance(e, tuple) else e
                              for e in sh.spec],
                     "shard_shape": list(local), "bytes_per_rank": nbytes}
    return {"leaves": out, "bytes_per_rank": total}


def cell_report(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The report of one cell (no allocation: every struct is a ``meta``
    tensor)."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, abstract=True)
    mb = TRAIN_MICROBATCHES.get(arch, 1)
    rules = make_rules(cfg, mesh, kind=shape.kind,
                       global_batch=shape.global_batch,
                       seq_len=shape.seq_len)
    rec = {"num_devices": mesh.size, "mesh_shape": list(mesh.shape),
           "mesh_axes": list(mesh.mesh_dim_names),
           "rules": {"table": {k: list(v) if v else None
                               for k, v in rules.table.items()},
                     "shard_heads": rules.shard_heads,
                     "shard_kv_heads": rules.shard_kv_heads,
                     "seq_shard_attn": rules.seq_shard_attn}}
    if shape.kind == "train":
        tc = TrainConfig(microbatches=mb)
        st = abstract_state(cfg, tc)
        rec["state"] = _layout(st, state_shardings(cfg, st, mesh))
    else:
        ps = serve_param_struct(cfg)
        rec["params"] = _layout(ps, named_sharding_tree(cfg, ps, mesh,
                                                        fsdp_params=False))
    rec["batch"] = _layout(SP.batch_struct(cfg, shape),
                           SP.batch_specs(cfg, rules, shape))
    if shape.kind == "decode":
        rec["caches"] = _layout(SP.cache_struct(cfg, shape),
                                SP.cache_specs(cfg, rules, shape))
    rec["bytes_per_rank"] = sum(rec[k]["bytes_per_rank"] for k in
                                ("state", "params", "batch", "caches")
                                if k in rec)
    ana = analytic_traffic(cfg, shape, multi_pod=multi_pod, microbatches=mb)
    mf = model_flops(cfg, shape)
    rec["analytic_traffic"] = ana
    rec["model_flops_global"] = mf
    rec["roofline"] = {**roofline_terms(mf / mesh.size, ana["total"], 0.0),
                       "collective": "not modeled"}
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str
             ) -> dict:
    shape = SHAPES_BY_NAME[shape_name]
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "multi_pod": multi_pod, "ok": False}
    try:
        rec.update(cell_report(arch, shape_name, multi_pod))
        rec["ok"] = True
    # a report run goes on past a failing cell and records it
    except Exception as e:  # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        tag = "multipod" if multi_pod else "pod"
        path = os.path.join(
            outdir, f"{arch.replace('/', '_')}__{shape_name}__{tag}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '?')})"
    print(f"[dryrun] {arch} x {shape_name} x "
          f"{'2x16x16' if multi_pod else '16x16'}: {status}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        ok = True
        for arch in ASSIGNED:
            for shape in assigned_shapes(get_config(arch)):
                ok &= run_cell(arch, shape.name, args.multi_pod,
                               args.out)["ok"]
        raise SystemExit(0 if ok else 1)

    assert args.arch and args.shape, "--arch and --shape (or --all)"
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.out)
    raise SystemExit(0 if rec["ok"] else 1)


if __name__ == "__main__":
    main()
