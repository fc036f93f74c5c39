"""The port's sharding rules, spec trees and dry-run layouts against the
JAX package's, with no process group.

The rule and spec builders of both packages read only a mesh's axis
names and sizes. The reference's read ``mesh.axis_names`` and
``mesh.devices.shape`` and build ``NamedSharding``s, so they get a
``jax.sharding.AbstractMesh`` with a ``devices`` array of the mesh's
shape; the port's get its own ``AbstractMesh``. For every registered
config × assigned shape × mesh ((16, 16), (2, 16, 16), (1, 4), (2, 2),
(4, 1)): ``make_rules``' table and booleans, ``param_specs`` (FSDP on and
off), ``state_shardings``, ``batch_specs`` and ``cache_specs`` spec for
spec, every DTensor placement a spec turns into, and every leaf's
per-rank shard shape in the dry-run report against the reference's
``NamedSharding.shard_shape``."""

import dataclasses

import numpy as np
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.config import TrainConfig as JTrainConfig
from repro.config import assigned_shapes as jassigned
from repro.config import get_config as jget
from repro.launch import specs as JSP
from repro.launch import steps as JST
from repro.models import sharding as JSH
from repro_torch.config import TrainConfig, assigned_shapes, get_config
from repro_torch.config import list_configs
from repro_torch.launch import dryrun, specs as SP, steps as ST
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import sharding as SH

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}


class _RefMesh(JAbstractMesh):
    """What the reference's builders read of a mesh, with no devices."""

    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


def _meshes(name):
    shape, axes = MESHES[name]
    return _RefMesh(shape, axes), AbstractMesh(shape, axes)


def _pairs(a, b, path=""):
    """(path, a leaf, b leaf) over two trees of the same keys."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _spec(x):
    return tuple(x.spec) if hasattr(x, "spec") else tuple(x)


def _cells():
    for name in list_configs():
        for shape in assigned_shapes(get_config(name)):
            yield name, shape


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_rules_equal_reference(mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    n = 0
    for name, shape in _cells():
        for kind in ("train", "prefill", "decode"):
            kw = dict(kind=kind, global_batch=shape.global_batch,
                      seq_len=shape.seq_len)
            want = JSH.make_rules(jget(name), jmesh, **kw)
            got = SH.make_rules(get_config(name), mesh, **kw)
            assert got.table == want.table, (name, shape.name, kind)
            for f in ("shard_heads", "shard_kv_heads", "seq_shard_attn"):
                assert getattr(got, f) == getattr(want, f), (name, f)
            for logical in want.table:
                assert tuple(got.spec(logical, None)) == \
                    tuple(want.spec(logical, None)), (name, logical)
            n += 1
    assert n >= 3 * 30


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_trees_equal_reference(mesh_name):
    from torch.distributed.tensor import Replicate, Shard

    jmesh, mesh = _meshes(mesh_name)
    axes = list(mesh.mesh_dim_names)
    for name, shape in _cells():
        jcfg, cfg = jget(name), get_config(name)
        jstate = JST.abstract_state(jcfg, JTrainConfig())
        state = ST.abstract_state(cfg, TrainConfig())
        for fsdp in (True, False):
            want = JSH.param_specs(jcfg, jstate["params"], jmesh,
                                   fsdp_params=fsdp)
            got = SH.param_specs(cfg, state["params"], mesh,
                                 fsdp_params=fsdp)
            for path, g, w in _pairs(got, want):
                assert _spec(g) == _spec(w), (name, path, fsdp)
        kw = dict(kind=shape.kind, global_batch=shape.global_batch,
                  seq_len=shape.seq_len)
        jrules = dataclasses.replace(JSH.make_rules(jcfg, jmesh, **kw),
                                     mesh=jmesh)
        rules = SH.make_rules(cfg, mesh, **kw)
        trees = [(ST.state_shardings(cfg, state, mesh),
                  JST.state_shardings(jcfg, jstate, jmesh)),
                 (SP.batch_specs(cfg, rules, shape),
                  JSP.batch_specs(jcfg, jrules, shape))]
        if shape.kind == "decode":
            trees.append((SP.cache_specs(cfg, rules, shape),
                          JSP.cache_specs(jcfg, jrules, shape)))
        for got, want in trees:
            for path, g, w in _pairs(got, want):
                assert _spec(g) == _spec(w), (name, shape.name, path)
                # the placements: Shard(i) on each mesh axis dim i names
                pl = g.placements
                for m, ax in enumerate(axes):
                    dims = [i for i, e in enumerate(_spec(w))
                            if e == ax or (isinstance(e, tuple) and ax in e)]
                    assert pl[m] == (Shard(dims[0]) if dims
                                     else Replicate()), (path, ax)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dryrun_shard_shapes_equal_reference(multi_pod):
    mesh_name = "2x16x16" if multi_pod else "16x16"
    jmesh, _ = _meshes(mesh_name)
    assert make_production_mesh(multi_pod=multi_pod, abstract=True) == \
        _meshes(mesh_name)[1]
    n = 0
    for name in dryrun.ASSIGNED:
        jcfg = jget(name)
        for shape in jassigned(jcfg):
            rep = dryrun.cell_report(name, shape.name, multi_pod)
            assert rep["num_devices"] == jmesh.size
            kw = dict(kind=shape.kind, global_batch=shape.global_batch,
                      seq_len=shape.seq_len)
            jrules = dataclasses.replace(JSH.make_rules(jcfg, jmesh, **kw),
                                         mesh=jmesh)
            if shape.kind == "train":
                mb = dryrun.TRAIN_MICROBATCHES.get(name, 1)
                st = JST.abstract_state(jcfg, JTrainConfig(microbatches=mb))
                parts = {"state": (st, JST.state_shardings(jcfg, st,
                                                           jmesh))}
            else:
                ps = JST.serve_param_struct(jcfg)
                parts = {"params": (ps, JSH.named_sharding_tree(
                    jcfg, ps, jmesh, fsdp_params=False))}
            parts["batch"] = (JSP.batch_struct(jcfg, shape),
                              JSP.batch_specs(jcfg, jrules, shape))
            if shape.kind == "decode":
                parts["caches"] = (JSP.cache_struct(jcfg, shape),
                                   JSP.cache_specs(jcfg, jrules, shape))
            total = 0
            for part, (structs, shardings) in parts.items():
                leaves = rep[part]["leaves"]
                for path, st_, sh in _pairs(structs, shardings):
                    if path == "/len":
                        continue  # a decode cache's length: a host int here
                    want = sh.shard_shape(st_.shape)
                    got = leaves[path]["shard_shape"]
                    assert tuple(got) == tuple(want), (name, part, path)
                    total += int(np.prod(want)) * st_.dtype.itemsize
                    n += 1
            assert rep["bytes_per_rank"] == total, (name, shape.name)
            assert rep["model_flops_global"] > 0
            assert rep["roofline"]["memory_s"] > 0
    assert n > 900  # every leaf of every cell
