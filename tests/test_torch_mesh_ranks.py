"""The port's multi-rank plane on four gloo ranks against the JAX
package's sharded steps on four fake devices, on the CPU.

One module fixture prepares the inputs (the JAX package's
``init_params`` of three reduced architectures, seeded batches, caches,
train states with random Adam moments at step 5, a checkpoint written
by the JAX package) and then starts, at the same time:

  * the JAX oracle: a subprocess with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, meshes built
    as ``jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
    ("data", "model"))`` (``jax.make_mesh`` makes Explicit axes, which the
    reference's ``shard_map`` bodies trip on), x64 on as in
    ``tests/conftest.py``; it runs the reference's jitted sharded steps
    and writes ``.npz`` files;
  * the port: four gloo processes through ``torch.distributed.run`` (this
    file's ``__main__``), which run the same steps on DTensors and write
    their global results.

Compared (f32, within 1e-4): prefill logits and caches, one decode step
and one train step (loss, grad norm, params, m, v) of ``olmoe-1b-7b`` on
(1, 4) (expert parallel), ``llama3.2-1b`` on (2, 2) and ``zamba2-2.7b``
on (2, 2) (recurrent: ``act_embed``, ``ssm_heads``); the EP MoE alone,
forward and gradients, against the reference's ``_moe_ep``; the int8
ring bit-equal to the reference's at a length that divides and one that
pads; a 4-rank checkpoint restored whole on one rank, and the JAX
package's checkpoint restored onto 4 ranks with ``shardings=``, bit for
bit; ``Trainer(mesh=)`` stepping as one rank's ``Trainer`` and resuming
from its sharded checkpoints on one rank.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_config as jget
from repro.config import reduced_config as jreduced
from repro.models import transformer as JT
from repro.train import checkpoint as JCK
from repro_torch.config import ShapeConfig, TrainConfig, get_config
from repro_torch.config import reduced_config
from repro_torch.train import checkpoint as CK

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)
#: (arch, mesh shape)
CASES = [("olmoe-1b-7b", (1, 4)), ("llama3.2-1b", (2, 2)),
         ("zamba2-2.7b", (2, 2))]
B, S, T = 4, 16, 24  # batch, prompt length, decode cache capacity
LAYERS = 2  # reduced configs at two layers (a hybrid's one super-block)
TC = dict(total_steps=20, warmup_steps=3, seed=0)
RING = (64, 61)  # a length the 4 ranks divide, and one they pad
CKPT_ARCH = "llama3.2-1b"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}__"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    root = {}
    for path, v in flat.items():
        parts = path.split("__")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return root


def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tree(flat, prefix):
    n = len(prefix)
    return _unflat({k[n:]: v for k, v in flat.items() if k.startswith(prefix)})


# ---------------------------------------------------------------------------
# inputs (in the test process)
# ---------------------------------------------------------------------------


def _inputs(arch, seed):
    cfg = jreduced(jget(arch), num_layers=LAYERS)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        np.asarray, JT.init_params(cfg, jax.random.PRNGKey(seed)))
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    dec_tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, -3:] = -1
    caches = jax.tree_util.tree_map(
        lambda a: (0.5 * rng.standard_normal(a.shape)).astype(a.dtype),
        JT.init_caches(cfg, B, T, dtype=jnp.float32)["layers"])
    like = lambda scale, f: jax.tree_util.tree_map(  # noqa: E731
        lambda p: f(rng.standard_normal(p.shape) * scale).astype(np.float32),
        params)
    m, v = like(1e-3, lambda a: a), like(1e-3, lambda a: a * a + 1e-6)
    out = {"tokens": tokens, "dec_tokens": dec_tokens, "labels": labels}
    for name, tree in (("params", params), ("caches", caches), ("m", m),
                       ("v", v)):
        out.update({f"{name}__{k}": a for k, a in _flat(tree).items()})
    # the EP MoE alone: layer 0's MoE params, a (B, S, d) input and the
    # cotangent its output is contracted with
    if cfg.family == "moe":
        out["moe_x"] = rng.standard_normal((B, S, cfg.d_model)
                                           ).astype(np.float32)
        out["moe_w"] = rng.standard_normal((B, S, cfg.d_model)
                                           ).astype(np.float32)
    return out


def _wait_for_inputs(d, timeout=180.0):
    """The processes start before the inputs are written (their imports
    and the process group overlap the test process's preparation)."""
    t0 = time.time()
    while not (Path(d) / "ready").exists():
        if time.time() - t0 > timeout:
            raise TimeoutError("no inputs")
        time.sleep(0.05)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    t0 = time.time()
    oracle = subprocess.Popen(
        [sys.executable, __file__, "--oracle", str(d)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                 "--xla_backend_optimization_level=0"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ranks = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=4", __file__, "--ranks", str(d)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        for i, (arch, _) in enumerate(CASES):
            np.savez(d / f"in_{arch}.npz", **_inputs(arch, i))
        ring = np.random.default_rng(9).standard_normal(
            (4, sum(RING))).astype(np.float32)
        np.save(d / "ring.npy", ring)
        # a JAX checkpoint of the llama train state, for the 4-rank restore
        flat = _load(d / f"in_{CKPT_ARCH}.npz")
        JCK.save(str(d / "jax_ckpt"), 5, {
            "params": _tree(flat, "params__"),
            "opt": {"m": _tree(flat, "m__"), "v": _tree(flat, "v__")},
            "step": np.int32(5)})
        (d / "ready").touch()
        o_out, _ = oracle.communicate(timeout=240)
        r_out, _ = ranks.communicate(timeout=240)
    finally:
        for p in (oracle, ranks):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert oracle.returncode == 0, o_out[-6000:]
    assert ranks.returncode == 0, r_out[-6000:]
    return {"dir": d, "ref": _load(d / "ref.npz"),
            "port": _load(d / "port.npz"), "seconds": time.time() - t0}


# ---------------------------------------------------------------------------
# the JAX oracle (a subprocess with 4 fake devices)
# ---------------------------------------------------------------------------


def _oracle(d):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.config import ShapeConfig as JShape
    from repro.launch import steps as JST
    from repro.models import moe as JM
    from repro.models.sharding import make_rules, use_rules
    from repro.train.compression import _ring_allreduce_int8
    from repro.utils.compat import shard_map

    jax.config.update("jax_enable_x64", True)
    assert jax.device_count() == 4, jax.devices()
    _wait_for_inputs(d)
    out = {}
    for arch, shape in CASES:
        cfg = jreduced(jget(arch), num_layers=LAYERS)
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        flat = _load(Path(d) / f"in_{arch}.npz")
        params = jax.tree_util.tree_map(jnp.asarray, _tree(flat, "params__"))
        with mesh:
            fn, ish, osh, _ = JST.build_prefill_step(
                cfg, mesh, JShape("p", S, B, "prefill"))
            logits, caches = jax.jit(fn, in_shardings=ish,
                                     out_shardings=osh)(
                params, {"tokens": jnp.asarray(flat["tokens"])})
            out[f"{arch}/prefill/logits"] = np.asarray(logits)
            for k, v in _flat(caches["layers"]).items():
                out[f"{arch}/prefill/caches/{k}"] = np.asarray(v)
            fn, ish, osh, _ = JST.build_decode_step(
                cfg, mesh, JShape("d", T, B, "decode"))
            dc = {"layers": jax.tree_util.tree_map(
                jnp.asarray, _tree(flat, "caches__")), "len": jnp.int32(S)}
            logits, caches = jax.jit(fn, in_shardings=ish,
                                     out_shardings=osh)(
                params, {"tokens": jnp.asarray(flat["dec_tokens"])}, dc)
            out[f"{arch}/decode/logits"] = np.asarray(logits)
            for k, v in _flat(caches["layers"]).items():
                out[f"{arch}/decode/caches/{k}"] = np.asarray(v)
            tc = JTrainConfig(**TC)
            fn, ish, osh, _ = JST.build_train_step(
                cfg, tc, mesh, JShape("t", S, B, "train"))
            state = {"params": params, "opt": {
                "m": jax.tree_util.tree_map(jnp.asarray, _tree(flat, "m__")),
                "v": jax.tree_util.tree_map(jnp.asarray, _tree(flat, "v__"))},
                "step": jnp.int32(5)}
            new, met = jax.jit(fn, in_shardings=ish, out_shardings=osh)(
                state, {"tokens": jnp.asarray(flat["tokens"]),
                        "labels": jnp.asarray(flat["labels"])})
            for k, v in met.items():
                out[f"{arch}/train/metrics/{k}"] = np.asarray(v)
            for part, tree in (("params", new["params"]),
                               ("m", new["opt"]["m"]),
                               ("v", new["opt"]["v"])):
                for k, v in _flat(tree).items():
                    out[f"{arch}/train/{part}/{k}"] = np.asarray(v)
            if cfg.family == "moe":
                rules = make_rules(cfg, mesh, kind="train", global_batch=B,
                                   seq_len=S)
                p0 = jax.tree_util.tree_map(
                    lambda a: a[0], params["stacked"]["block"]["moe"])
                x, w = jnp.asarray(flat["moe_x"]), jnp.asarray(flat["moe_w"])

                def f(p, x):
                    with use_rules(rules):
                        y, aux = JM._moe_ep(cfg, p, x)
                    return jnp.sum(y * w) + aux, y

                (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
                    f, argnums=(0, 1), has_aux=True))(p0, x)
                out[f"{arch}/ep/y"] = np.asarray(y)
                out[f"{arch}/ep/grad_x"] = np.asarray(gx)
                for k, v in _flat(gp).items():
                    out[f"{arch}/ep/grad/{k}"] = np.asarray(v)
    ring = np.load(Path(d) / "ring.npy")
    mesh = Mesh(np.array(jax.devices()), ("data",))
    fn = jax.jit(shard_map(lambda x: _ring_allreduce_int8(x[0], "data")[None],
                           mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                           check=False))
    off = 0
    for n in RING:
        part = jax.device_put(jnp.asarray(ring[:, None, off:off + n]),
                              NamedSharding(mesh, P("data")))
        out[f"ring/{n}"] = np.asarray(fn(part))[:, 0]
        off += n
    np.savez(Path(d) / "ref.npz", **out)


# ---------------------------------------------------------------------------
# the port on 4 gloo ranks
# ---------------------------------------------------------------------------


def _ranks(d):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as TT
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.sharding import make_rules, to_layout, use_rules
    from repro_torch.train.compression import _ring_allreduce_int8

    dev = init_ranks("gloo", device="cpu")
    rank = dist.get_rank()
    _wait_for_inputs(d)
    full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t  # noqa
    out = {}

    def put(key, t):
        t = full(t)
        if rank == 0:
            out[key] = t.detach().numpy()

    t0 = time.time()

    def lap(what):
        if rank == 0 and os.environ.get("MESH_RANKS_TIMES"):
            print(f"[ranks] {what} {time.time() - t0:.1f} s", flush=True)

    for arch, shape in CASES:
        cfg = reduced_config(get_config(arch), num_layers=LAYERS)
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        flat = _load(Path(d) / f"in_{arch}.npz")
        params = TT.params_from_reference(cfg, _tree(flat, "params__"), dev)
        tok = lambda k: torch.from_numpy(flat[k])  # noqa: E731
        fn, _, _, _ = ST.build_prefill_step(
            cfg, mesh, ShapeConfig("p", S, B, "prefill"))
        logits, caches = fn(params, {"tokens": tok("tokens")})
        put(f"{arch}/prefill/logits", logits)
        lap(f"{arch} prefill")
        for k, v in _flat(caches["layers"]).items():
            put(f"{arch}/prefill/caches/{k}", v)
        fn, _, _, _ = ST.build_decode_step(
            cfg, mesh, ShapeConfig("d", T, B, "decode"))
        dc = TT.caches_from_reference(
            cfg, {"layers": _tree(flat, "caches__"), "len": S}, dev)
        logits, caches = fn(params, {"tokens": tok("dec_tokens")}, dc)
        put(f"{arch}/decode/logits", logits)
        lap(f"{arch} decode")
        for k, v in _flat(caches["layers"]).items():
            put(f"{arch}/decode/caches/{k}", v)
        tc = TrainConfig(**TC)
        fn, in_sh, _, _ = ST.build_train_step(
            cfg, tc, mesh, ShapeConfig("t", S, B, "train"))
        state = TT.state_from_reference(cfg, {
            "params": _tree(flat, "params__"),
            "opt": {"m": _tree(flat, "m__"), "v": _tree(flat, "v__")},
            "step": np.int32(5)}, dev)
        new, met = fn(state, {"tokens": tok("tokens"),
                              "labels": tok("labels")})
        for k, v in met.items():
            put(f"{arch}/train/metrics/{k}", v)
        for part, tree in (("params", new["params"]),
                           ("m", new["opt"]["m"]), ("v", new["opt"]["v"])):
            for k, v in _flat(tree).items():
                put(f"{arch}/train/{part}/{k}", v)
        lap(f"{arch} train")
        if arch == CKPT_ARCH:  # a 4-rank save, for a 1-rank restore
            CK.save(str(Path(d) / "port_ckpt"), 6, new)
        if cfg.family == "moe":
            rules = make_rules(cfg, mesh, kind="train", global_batch=B,
                               seq_len=S)
            p0 = {k: torch.from_numpy(v[0].copy()) for k, v in _flat(
                _tree(flat, "params__stacked__block__moe__")).items()}
            p0 = _unflat(p0)
            xs = to_layout(torch.from_numpy(flat["moe_x"]),
                           rules.spec("batch", None, None), mesh)
            w = torch.from_numpy(flat["moe_w"])
            pd = ST.lay_out(p0, ST.named_sharding_tree(cfg, p0, mesh), mesh)
            leaves = [xs, *[v for v in _flat(pd).values()]]
            for t in leaves:
                t.requires_grad_(True)
            with use_rules(rules), implicit_replication():
                y, aux = M._moe_ep(cfg, pd, xs)
                (y * w).sum().add(aux).backward()
            put(f"{arch}/ep/y", y)
            put(f"{arch}/ep/grad_x", xs.grad)
            for k, v in _flat(pd).items():
                put(f"{arch}/ep/grad/{k}", v.grad)
    lap("ep")
    # Trainer(mesh=): two steps, an async sharded checkpoint each step
    from repro_torch.train.trainer import Trainer

    cfg = reduced_config(get_config(CKPT_ARCH), num_layers=LAYERS)
    tr = Trainer(cfg, TrainConfig(**TC, checkpoint_every=1,
                                  checkpoint_dir=str(Path(d) / "trainer")),
                 global_batch=B, seq_len=S, device=dev,
                 mesh=make_mesh((2, 2), ("data", "model"), device="cpu"),
                 shape=ShapeConfig("t", S, B, "train"))
    tr.init_or_resume(resume=False)
    losses = tr.run(2, with_guard=False)["losses"]
    if rank == 0:
        out["trainer_losses"] = np.array(losses)
    lap("trainer")
    # a dim split over two mesh axes: rank (i, j) holds block 2 i + j, the
    # row-major order of JAX's axis tuple ("data", "model")
    from repro_torch.models.sharding import P

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    t = to_layout(torch.arange(16), P(("data", "model")), mesh)
    i, j = (mesh.get_local_rank(a) for a in ("data", "model"))
    mine = torch.tensor([int(torch.equal(
        t.to_local(), torch.arange(16)[4 * (2 * i + j):4 * (2 * i + j + 1)]))])
    every = [torch.empty_like(mine) for _ in range(4)]
    dist.all_gather(every, mine)
    if rank == 0:
        out["two_axis_order"] = torch.cat(every).numpy()
    # the int8 ring on the 4 ranks' own rows
    ring = torch.from_numpy(np.load(Path(d) / "ring.npy"))
    off = 0
    for n in RING:
        got = _ring_allreduce_int8(ring[rank, off:off + n].clone())
        every = [torch.empty_like(got) for _ in range(4)]
        dist.all_gather(every, got)
        if rank == 0:
            out[f"ring/{n}"] = torch.stack(every).numpy()
        off += n
    # the JAX package's checkpoint restored onto the (2, 2) mesh
    cfg = reduced_config(get_config(CKPT_ARCH), num_layers=LAYERS)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    sh = ST.state_shardings(cfg, ST.abstract_state(cfg, TrainConfig()), mesh)
    step, st = CK.restore(str(Path(d) / "jax_ckpt"), shardings=sh,
                          device=dev)
    assert step == 5
    local = 0
    for k, v in _flat(st).items():
        assert isinstance(v, DTensor), k
        local += v.to_local().numel()
        put(f"restored/{k}", v)
    out["restored_local_elems"] = np.int64(local)  # rank 0's blocks
    lap("ring, restore")
    if rank == 0:
        np.savez(Path(d) / "port.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _close(runs, key):
    np.testing.assert_allclose(runs["port"][key], runs["ref"][key], **TOL,
                               err_msg=key)


def _keys(runs, prefix):
    ks = [k for k in runs["ref"] if k.startswith(prefix)]
    assert ks and all(k in runs["port"] for k in ks), prefix
    return ks


@pytest.mark.parametrize("arch", [a for a, _ in CASES])
def test_sharded_prefill_and_decode_equal_reference(runs, arch):
    for phase in ("prefill", "decode"):
        keys = _keys(runs, f"{arch}/{phase}/")
        assert f"{arch}/{phase}/logits" in keys
        for k in keys:
            _close(runs, k)


@pytest.mark.parametrize("arch", [a for a, _ in CASES])
def test_sharded_train_step_equals_reference(runs, arch):
    keys = _keys(runs, f"{arch}/train/")
    for m in ("loss", "grad_norm", "lr", "aux"):
        assert f"{arch}/train/metrics/{m}" in keys
    moved = 0
    for k in keys:
        _close(runs, k)
        if "/params/" in k:
            moved += 1
    assert moved == len([k for k in runs["ref"]
                         if k.startswith(f"{arch}/train/params/")]) > 0


def test_expert_parallel_moe_and_its_gradients_equal_reference(runs):
    keys = _keys(runs, "olmoe-1b-7b/ep/")
    assert {"olmoe-1b-7b/ep/y", "olmoe-1b-7b/ep/grad_x"} <= set(keys)
    assert any("expert_w1" in k for k in keys)
    for k in keys:
        _close(runs, k)


def test_trainer_on_a_mesh_steps_as_one_rank_and_checkpoints(runs):
    """``Trainer(mesh=(2, 2), shape=)`` on 4 ranks: the same losses as one
    rank's ``Trainer`` from the same seed, and its sharded checkpoints
    resume on one rank."""
    import tempfile

    from repro_torch.train.trainer import Trainer

    cfg = reduced_config(get_config(CKPT_ARCH), num_layers=LAYERS)
    with tempfile.TemporaryDirectory() as d:
        one = Trainer(cfg, TrainConfig(**TC, checkpoint_every=10**9,
                                       checkpoint_dir=d),
                      global_batch=B, seq_len=S, device="cpu")
        one.init_or_resume(resume=False)
        want = one.run(2, with_guard=False)["losses"]
    np.testing.assert_allclose(runs["port"]["trainer_losses"], want, **TOL)
    assert CK.latest_step(str(runs["dir"] / "trainer")) == 2
    resumed = Trainer(cfg, TrainConfig(**TC, checkpoint_dir=str(
        runs["dir"] / "trainer")), global_batch=B, seq_len=S, device="cpu")
    assert resumed.init_or_resume() == 2


def test_a_dim_split_over_two_axes_is_row_major_as_in_jax(runs):
    assert runs["port"]["two_axis_order"].tolist() == [1, 1, 1, 1]


@pytest.mark.parametrize("n", RING)
def test_int8_ring_is_bit_equal_to_reference(runs, n):
    got, want = runs["port"][f"ring/{n}"], runs["ref"][f"ring/{n}"]
    assert got.shape == want.shape == (4, n)
    assert np.array_equal(got, want)
    exact = np.load(runs["dir"] / "ring.npy")
    off = sum(RING[:RING.index(n)])
    exact = exact[:, off:off + n].sum(0)
    assert np.abs(got - exact).max() / np.abs(exact).max() < 0.08


def test_checkpoints_cross_ranks_and_packages(runs):
    d = runs["dir"]
    # 4-rank save -> 1-rank restore: the saved state, bit for bit
    step, st = CK.restore(str(d / "port_ckpt"), device="cpu")
    assert step == 6
    got = _flat(st)
    for part, sub in (("params", "params"), ("m", "opt__m"),
                      ("v", "opt__v")):
        for k, v in got.items():
            if k.startswith(sub + "__"):
                want = runs["port"][f"{CKPT_ARCH}/train/{part}/"
                                    f"{k[len(sub) + 2:]}"]
                assert np.array_equal(v.numpy(), want), k
    assert int(got["step"]) == 6
    # ... and it is a checkpoint the JAX package restores
    jstep, jst = JCK.restore(str(d / "port_ckpt"))
    assert jstep == 6 and np.array_equal(
        np.asarray(jst["params"]["out_head"]["table"]),
        got["params__out_head__table"].numpy())
    # the JAX package's checkpoint placed on 4 ranks: every leaf whole again
    # bit for bit, each rank holding its blocks only
    _, jst = JCK.restore(str(d / "jax_ckpt"))
    n_all = 0
    for k, v in _flat(jst).items():
        assert np.array_equal(runs["port"][f"restored/{k}"], np.asarray(v)), k
        n_all += np.asarray(v).size
    assert 0 < int(runs["port"]["restored_local_elems"]) < n_all


if __name__ == "__main__":
    if sys.argv[1] == "--oracle":
        _oracle(sys.argv[2])
    else:
        _ranks(sys.argv[2])
