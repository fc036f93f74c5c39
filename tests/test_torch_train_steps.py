"""The port's train step against the JAX package's, at f32 on the CPU.

One ``build_train_step`` step from the same carried state (the JAX
package's ``init_params(cfg, PRNGKey(0))``, seeded random Adam moments,
step 5 so the learning rate is not 0) on the same seeded batch, for a
dense, a MoE, a hybrid and an xLSTM architecture (reduced), one of them
with two microbatches: the metrics and every updated leaf of params,
``m`` and ``v`` within 1e-4, the model tests' tolerance (f32 on both
sides, sums in another order). Block remat changes no bit of a step, and
every registered architecture takes a finite step (as
``tests/test_models_smoke.py`` does for the reference).

Each reference step is jitted and run once per worker
(``reference_step``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_config as jget
from repro.config import reduced_config as jreduced
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models import transformer as JT
from repro_torch.config import TrainConfig, get_config, list_configs
from repro_torch.config import reduced_config
from repro_torch.launch.steps import build_train_step
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import init_opt_state

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 32
#: (arch, microbatches)
CARRIED = [("llama3.2-1b", 1), ("olmoe-1b-7b", 2), ("zamba2-2.7b", 1),
           ("xlstm-125m", 1)]
TC = dict(total_steps=20, warmup_steps=3, seed=0)


def train_batch(cfg, b, s, rng):
    """A train batch for any input mode, as numpy; some labels -1."""
    out = {}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        n_img = cfg.num_image_tokens if cfg.input_mode == "tokens+image" \
            else 0
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (b, s - n_img)).astype(np.int32)
        if n_img:
            out["image_embeds"] = rng.standard_normal(
                (b, n_img, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[:, -3:] = -1
    out["labels"] = labels
    return out


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def start_state(params, seed):
    """The carried state: params, random m and v >= 0, step 5 (numpy)."""
    rng = np.random.default_rng(seed)
    like = lambda scale, f: jax.tree_util.tree_map(  # noqa: E731
        lambda p: f(rng.standard_normal(p.shape) * scale).astype(np.float32),
        params)
    return {"params": params,
            "opt": {"m": like(1e-3, lambda a: a),
                    "v": like(1e-3, lambda a: a * a + 1e-6)},
            "step": np.int32(5)}


@functools.lru_cache(maxsize=None)
def reference_step(arch, mb):
    """The JAX package's reduced ``arch``, its start state and batch (numpy)
    and one jitted train step's new state and metrics."""
    cfg = jreduced(jget(arch))
    params = jax.tree_util.tree_map(
        np.asarray, JT.init_params(cfg, jax.random.PRNGKey(0)))
    state = start_state(params, seed=1)
    batch = train_batch(cfg, B * mb, S, np.random.default_rng(2))
    step, _, _, _ = jbuild_train_step(cfg, JTrainConfig(**TC,
                                                        microbatches=mb))
    new, met = jax.jit(step)(
        jax.tree_util.tree_map(jnp.asarray, state),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(state=state, batch=batch,
                new=jax.tree_util.tree_map(np.asarray, new),
                metrics={k: float(v) for k, v in met.items()})


def port_step(arch, state, batch, mb=1, **over):
    cfg = reduced_config(get_config(arch), **over)
    st = T.state_from_reference(cfg, state, device="cpu")
    step, _, _, _ = build_train_step(cfg, TrainConfig(**TC, microbatches=mb))
    new, met = step(st, to_torch(batch))
    return new, {k: float(v) for k, v in met.items()}


@pytest.mark.parametrize("arch,mb", CARRIED, ids=[a for a, _ in CARRIED])
def test_train_step_equals_reference(arch, mb):
    ref = reference_step(arch, mb)
    new, met = port_step(arch, ref["state"], ref["batch"], mb)
    assert sorted(met) == sorted(ref["metrics"]) == \
        ["aux", "grad_norm", "loss", "lr"]
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(met[k], want, **TOL, err_msg=k)
    assert (met["aux"] > 0) == (arch == "olmoe-1b-7b")
    assert int(new["step"]) == 6 and new["step"].dtype == torch.int32
    got, want = flat(new), flat(ref["new"])
    assert sorted(got) == sorted(want)
    moved = 0
    for k in want:
        if k == "step":
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k], **TOL,
                                   err_msg=k)
        moved += k.startswith("params/") and not np.array_equal(
            want[k], flat(ref["state"])[k])
    assert moved == len(flat(ref["state"]["params"]))  # every leaf stepped


@pytest.mark.parametrize("arch,mb", CARRIED, ids=[a for a, _ in CARRIED])
def test_block_remat_changes_no_bit(arch, mb):
    ref = reference_step(arch, mb)
    on, met_on = port_step(arch, ref["state"], ref["batch"], mb,
                           remat="block")
    off, met_off = port_step(arch, ref["state"], ref["batch"], mb,
                             remat="none")
    assert met_on == met_off
    a, b = flat(on), flat(off)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_train_step_smoke(arch):
    """Every registered architecture, reduced: a port-only step from the
    port's own init is finite, advances the step and moves every param."""
    cfg = reduced_config(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in flat(params).items()}
    state = {"params": params, "opt": init_opt_state(params),
             "step": torch.tensor(3, dtype=torch.int32)}
    step, _, _, _ = build_train_step(cfg, TrainConfig(**TC))
    batch = train_batch(cfg, B, 64, np.random.default_rng(3))
    new, met = step(state, to_torch(batch))
    assert all(np.isfinite(float(v)) for v in met.values())
    assert int(new["step"]) == 4
    after = flat(new["params"])
    assert all(torch.isfinite(after[k]).all() for k in after)
    assert all(not torch.equal(after[k], before[k]) for k in after)
    assert all(p.grad is None and not p.requires_grad
               for p in after.values())
