"""The port's training substrate against the JAX package's, on the CPU.

The chunked loss (value and gradients), the schedule and AdamW, int8
quantisation and error feedback, checkpoints across the two packages,
the trainer's resume (bit for bit in the port; a JAX run continued by the
port), the fault handlers, the input stand-ins and the roofline. Inputs
are seeded numpy arrays; tolerances are stated per test."""

import os
import shutil
import signal
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_config as jget
from repro.config import list_configs
from repro.config import reduced_config as jreduced
from repro.config.base import assigned_shapes as jassigned_shapes
from repro.launch import specs as JS
from repro.roofline import analysis as JR
from repro.roofline import analytic as JA
from repro.train import checkpoint as JCK
from repro.train import compression as JC
from repro.train import fault as JF
from repro.train import losses as JL
from repro.train import optimizer as JO
from repro.train.trainer import Trainer as JTrainer
from repro_torch.config import TrainConfig, get_config, reduced_config
from repro_torch.config.base import assigned_shapes
from repro_torch.launch import specs as S
from repro_torch.launch.steps import abstract_state, serve_param_struct
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis as R
from repro_torch.roofline import analytic as A
from repro_torch.train import checkpoint as CK
from repro_torch.train import compression as C
from repro_torch.train import fault as F
from repro_torch.train import losses as L
from repro_torch.train import optimizer as O
from repro_torch.train.trainer import Trainer
from repro_torch.utils import tree as TR

ARCHS = sorted(list_configs())


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def test_tree_helpers_equal_reference():
    from repro.utils import tree as JTR

    rng = np.random.default_rng(0)
    tree = {"b": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "i": np.arange(5, dtype=np.int32)},
            "a": rng.standard_normal((7,)).astype(np.float32)}
    mine = TR.tree_map(torch.from_numpy, tree)
    assert TR.tree_num_params(mine) == JTR.tree_num_params(tree) == 24
    assert TR.tree_size_bytes(mine) == JTR.tree_size_bytes(tree) == 96
    # sorted key order, as jax.tree_util flattens a dict
    assert [tuple(l.shape) for l in TR.tree_leaves(mine)] == \
        [l.shape for l in jax.tree_util.tree_leaves(tree)]
    half = TR.tree_cast(mine, torch.bfloat16)
    assert half["b"]["w"].dtype == torch.bfloat16
    assert half["b"]["i"].dtype == torch.int32
    assert all(float(z.abs().sum()) == 0
               for z in TR.tree_leaves(TR.tree_zeros_like(mine)))
    for n in (0, 1023, 1024, 5 * 2**30, 3.5 * 2**50):
        assert TR.fmt_bytes(n) == JTR.fmt_bytes(n)


# ---------------------------------------------------------------------------
# loss and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_chunks", [1, 3])
def test_chunked_lm_loss_and_grads_equal_reference(num_chunks):
    cfg = reduced_config(get_config("llama3.2-1b"), vocab_size=300)
    jcfg = jreduced(jget("llama3.2-1b"), vocab_size=300)
    assert cfg.padded_vocab == 384  # 84 padded rows never labelled
    rng = np.random.default_rng(num_chunks)
    h = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    table = (rng.standard_normal((cfg.padded_vocab, cfg.d_model)) * 0.1
             ).astype(np.float32)
    lab = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    lab[0, 1] = lab[1, 4] = lab[1, 5] = -1

    def jloss(h, t):
        return JL.chunked_lm_loss(jcfg, {"table": t}, h, jnp.asarray(lab),
                                  z_coef=1e-2, num_chunks=num_chunks)[0]

    jv, (jgh, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(table))
    th = torch.from_numpy(h).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    v, met = L.chunked_lm_loss(cfg, {"table": tt}, th, torch.from_numpy(lab),
                               z_coef=1e-2, num_chunks=num_chunks)
    v.backward()
    assert float(met["tokens"]) == 9
    tol = dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(v), np.asarray(jv), **tol)
    np.testing.assert_allclose(_np(th.grad), np.asarray(jgh), **tol)
    np.testing.assert_allclose(_np(tt.grad), np.asarray(jgt), **tol)
    assert float(tt.grad[cfg.vocab_size:].abs().max()) > 0  # logz reaches pads


def test_lr_schedule_equals_reference():
    kw = dict(learning_rate=3e-4, warmup_steps=10, total_steps=100)
    tc, jtc = TrainConfig(**kw), JTrainConfig(**kw)
    for s in (0, 1, 10, 55, 100, 140):
        got = O.lr_schedule(tc, torch.tensor(s, dtype=torch.int32))
        want = JO.lr_schedule(jtc, jnp.int32(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-7,
                                   atol=0)


def _opt_tree(rng, scale):
    """Leaves of every kind the decay mask tells apart."""
    shapes = {"blk": {"w": (3, 4, 5), "scale": (3, 5), "bias": (5,)},
              "ssm": {"a_log": (4,), "dt_bias": (4,), "d_skip": (4,),
                      "w": (6, 7)},
              "emb": {"table": (10, 4)}, "vec": {"g": (9,)}}
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("gscale", [1e-2, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_equals_reference(gscale):
    rng = np.random.default_rng(4)
    p, g = _opt_tree(rng, 1.0), _opt_tree(rng, gscale)
    m = _opt_tree(rng, 1e-2)
    v = jax.tree_util.tree_map(np.square, _opt_tree(rng, 1e-2))
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=0.1)
    jp, jo, jmet = JO.adamw_update(JTrainConfig(**kw), p, g,
                                   {"m": m, "v": v}, jnp.int32(3))
    t = lambda tree: TR.tree_map(  # noqa: E731
        lambda a: torch.from_numpy(a.copy()), tree)
    tp, to, met = O.adamw_update(TrainConfig(**kw), t(p), t(g),
                                 {"m": t(m), "v": t(v)},
                                 torch.tensor(3, dtype=torch.int32))
    assert (float(met["grad_norm"]) > 1.0) == (gscale > 1)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=1e-6, atol=0)
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        got, want = flat(got), flat(want)
        for k in want:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert O._decay_mask("/blk/w") and not O._decay_mask("/ssm/a_log")


def test_quant_and_error_feedback_equal_reference():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4097) * 3).astype(np.float32)
    q, s = C._quant(torch.from_numpy(x))
    jq, js = JC._quant(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(_np(s), np.asarray(js))
    assert np.array_equal(C._dequant(q, s).numpy(),
                          np.asarray(JC._dequant(jq, js)))
    g = {"a": rng.standard_normal(256).astype(np.float32),
         "b": {"c": rng.standard_normal((8, 3)).astype(np.float32)}}
    ef = C.ErrorFeedback(TR.tree_map(torch.from_numpy, g))
    jef = JC.ErrorFeedback(g)
    for _ in range(50):
        red = ef.apply(TR.tree_map(torch.from_numpy, g), lambda t: t * 2)
        jred = jef.apply(g, lambda t: t * 2)
        for got, want in ((red, jred), (ef.residual, jef.residual)):
            got, want = flat(got), flat(want)
            for k in want:
                assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


# ---------------------------------------------------------------------------
# checkpoints and the trainer
# ---------------------------------------------------------------------------


def _mk_trainer(d, cls=Trainer, tcls=TrainConfig, get=get_config,
                red=reduced_config, **kw):
    cfg = red(get("smollm-360m"))
    tc = tcls(total_steps=10, warmup_steps=2, checkpoint_every=4,
              checkpoint_dir=d, seed=0)
    if cls is Trainer:
        kw.setdefault("device", "cpu")
    return cls(cfg, tc, global_batch=4, seq_len=32, **kw)


def test_checkpoint_atomic_and_gc():
    with tempfile.TemporaryDirectory() as d:
        state = {"a": {"w": torch.arange(6).reshape(2, 3)},
                 "step": torch.tensor(3, dtype=torch.int32)}
        for s in (1, 2, 3, 4, 5):
            CK.save(d, s, state, keep=2)
        assert CK.latest_step(d) == 5
        kept = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        assert kept == ["step_4", "step_5"]
        assert not any(x.startswith(".tmp") for x in os.listdir(d))
        step, restored = CK.restore(d, device="cpu")
        assert step == 5
        assert torch.equal(restored["a"]["w"], state["a"]["w"])
        assert restored["step"].dtype == torch.int32


def test_checkpoints_cross_packages():
    rng = np.random.default_rng(6)
    state = {"params": {"blk": {"w": rng.standard_normal((2, 3, 4))
                                .astype(np.float32)}},
             "opt": {"m": {"blk": {"w": np.zeros((2, 3, 4), np.float32)}}},
             "step": np.int32(7)}
    with tempfile.TemporaryDirectory() as d:
        # the port's save -> the reference's restore
        CK.save(d, 7, TR.tree_map(torch.as_tensor, state), meta={"x": 1})
        step, got = JCK.restore(d)
        assert step == 7
        for k, want in flat(state).items():
            a = np.asarray(flat(got)[k])
            assert a.dtype == np.asarray(want).dtype and np.array_equal(
                a, want), k
        # the reference's save -> the port's restore
        JCK.save(d, 9, jax.tree_util.tree_map(jnp.asarray, state))
        step, got = CK.restore(d, device="cpu")
        assert step == 9
        for k, want in flat(state).items():
            a = flat(got)[k]
            assert isinstance(a, torch.Tensor) and np.array_equal(
                a.numpy(), want), k
        assert got["step"].shape == () and got["step"].dtype == torch.int32


def test_async_save_keeps_the_state_as_it_was():
    """The optimizer writes the state in place after ``save``: the
    checkpoint still holds the values at the call."""
    with tempfile.TemporaryDirectory() as d:
        w = torch.arange(1 << 22, dtype=torch.float32)
        ck = CK.AsyncCheckpointer(d)
        ck.save(1, {"w": w})
        w.add_(1.0)
        ck.wait()
        _, got = CK.restore(d, device="cpu")
        assert torch.equal(got["w"], w - 1.0)


def test_port_resume_bitwise_identical():
    with tempfile.TemporaryDirectory() as d1:
        tr = _mk_trainer(d1)
        tr.init_or_resume(resume=False)
        full = tr.run(8, with_guard=False)["losses"]
        final = flat(tr.state)
    with tempfile.TemporaryDirectory() as d2:
        tr1 = _mk_trainer(d2)
        tr1.init_or_resume(resume=False)
        part1 = tr1.run(4, with_guard=False)["losses"]
        tr2 = _mk_trainer(d2)
        assert tr2.init_or_resume(resume=True) == 4
        part2 = tr2.run(4, with_guard=False)["losses"]
        resumed = flat(tr2.state)
    assert np.array_equal(np.array(full), np.array(part1 + part2))
    assert sorted(final) == sorted(resumed)
    assert all(torch.equal(final[k], resumed[k]) for k in final)


def test_port_trainer_continues_a_jax_run():
    """A JAX run of 8 steps checkpoints at step 4; the port's trainer
    resumes that checkpoint and its steps 4-7 lose what the JAX run's
    did, within 1e-4 (f32, sums in another order)."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        jtr = _mk_trainer(d1, cls=JTrainer, tcls=JTrainConfig, get=jget,
                          red=jreduced)
        jtr.init_or_resume(resume=False)
        want = jtr.run(8, with_guard=False)["losses"]
        shutil.copytree(os.path.join(d1, "step_4"),
                        os.path.join(d2, "step_4"))
        tr = _mk_trainer(d2)
        assert tr.init_or_resume(resume=True) == 4
        got = tr.run(4, with_guard=False)
    assert got["final_step"] == 8
    np.testing.assert_allclose(got["losses"], want[4:], rtol=1e-4, atol=1e-4)


def test_preemption_signal_stops_the_run_and_checkpoints():
    with tempfile.TemporaryDirectory() as d:
        tr = _mk_trainer(d)
        tr.init_or_resume(resume=False)
        before = signal.getsignal(signal.SIGTERM)
        batch_at = tr.batch_at

        def batch_then_signal(step):
            if step == 2:
                handler = signal.getsignal(signal.SIGTERM)
                assert getattr(handler, "__self__", None).__class__ is \
                    F.PreemptionGuard, "the guard holds no SIGTERM handler"
                signal.raise_signal(signal.SIGTERM)
            return batch_at(step)

        tr.batch_at = batch_then_signal
        out = tr.run(10, with_guard=True)
        assert out["final_step"] == 3 and len(out["losses"]) == 3
        assert CK.latest_step(d) == 3
        assert signal.getsignal(signal.SIGTERM) is before


def test_straggler_watchdog_flags_as_reference():
    rng = np.random.default_rng(7)
    dts = 0.1 + 0.002 * rng.standard_normal(60)
    dts[[12, 30, 31, 47]] = [0.5, 0.9, 0.11, 1.3]
    dts[3] = 0.4  # inside the warm-up: primes sigma
    mine, ref = F.StragglerWatchdog(k=3.0, warmup=5), \
        JF.StragglerWatchdog(k=3.0, warmup=5)
    for i, dt in enumerate(dts):
        assert mine.observe(i, float(dt)) == ref.observe(i, float(dt)), i
    assert mine.flagged == ref.flagged and mine.flagged
    info = F.elastic_info("cpu")
    assert info == {"devices": 1, "mesh": (1, 1), "axes": ("data", "model")}


# ---------------------------------------------------------------------------
# stand-ins and the roofline
# ---------------------------------------------------------------------------


def _struct(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flat(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_structs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for shape, jshape in zip(assigned_shapes(cfg), jassigned_shapes(jcfg)):
        assert shape.name == jshape.name
        b = S.batch_struct(cfg, shape)
        assert all(t.device.type == "meta" for t in b.values())
        assert _struct(b) == _struct(JS.batch_struct(jcfg, jshape))
        c, jc = S.cache_struct(cfg, shape), JS.cache_struct(jcfg, jshape)
        assert _struct(c["layers"]) == _struct(jc["layers"])
        assert c["len"] == 0 and jc["len"].shape == ()  # a host int here
    st = abstract_state(cfg, TrainConfig())
    assert st["step"].shape == () and st["step"].dtype == torch.int32
    assert all(t.device.type == "meta" for t in TR.tree_leaves(st))
    small = reduced_config(cfg)
    own = T.init_params(small, torch.Generator().manual_seed(0))
    sst = abstract_state(small, TrainConfig())
    assert _struct(sst["params"]) == _struct(own) == _struct(sst["opt"]["m"])
    sp = serve_param_struct(cfg)
    for k, (shp, dt) in _struct(sp).items():
        assert dt == (cfg.dtype if len(shp) >= 2 else "float32"), k


def test_roofline_equals_reference():
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget(arch)
        assert R.active_params(cfg) == JR.active_params(jcfg)
        for shape, jshape in zip(assigned_shapes(cfg),
                                 jassigned_shapes(jcfg)):
            assert R.model_flops(cfg, shape) == JR.model_flops(jcfg, jshape)
            for mp in (False, True):
                assert A.traffic(cfg, shape, multi_pod=mp, microbatches=4) \
                    == JA.traffic(jcfg, jshape, multi_pod=mp,
                                  microbatches=4), (arch, shape.name, mp)
    jhw = JR.HW()
    hw = R.HW(peak_flops=jhw.peak_flops, hbm_bw=jhw.hbm_bw,
              link_bw=jhw.ici_bw)
    for args in ((197e12, 0.0, 0.0), (1e12, 819e9, 1e9), (1e9, 1e6, 5e10),
                 (0.0, 0.0, 0.0)):
        assert R.roofline_terms(*args, hw) == JR.roofline_terms(*args, jhw)
    h100 = R.HW()
    assert (h100.peak_flops, h100.hbm_bw) == (989e12, 3.35e12)
    t = R.roofline_terms(989e12, 3.35e12 / 2, 0.0)
    assert t["dominant"] == "compute" and abs(t["compute_s"] - 1.0) < 1e-12
