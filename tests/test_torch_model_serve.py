"""The port's whole models and plaintext ``ServeEngine`` against the JAX
package's, at f32 on the CPU.

For every registered architecture (reduced): the train-mode hidden state
and aux loss, prefill logits and the cache tree, then one decode step
from the port's own grown caches, against the reference's, on the JAX
package's ``init_params(cfg, PRNGKey(0))`` carried across with
``params_from_reference``. The engine gives the reference engine's greedy
tokens, and its decode equals its own prefill over the grown prompt.
Tolerance as in ``test_torch_models.py`` (f32 on both sides, sums in
another order): 1e-4 relative and absolute.

Building the reference params dominates this file's time (about 23 s for
the 11 architectures on a CPU), so each architecture's are built once
(``reference_model``) and every reference call runs under ``jax.jit``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget
from repro.config import list_configs
from repro.config import reduced_config as jreduced
from repro.models import transformer as JT
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.config import get_config, reduced_config
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import Request

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = sorted(list_configs())
B, S = 2, 17  # a prompt length that is no multiple of a chunk
CAPACITY = S + 3


def jitted(fn):
    """A reference function compiled whole (config and mode static): one
    XLA compile instead of one per eager op keeps the tests short."""
    return jax.jit(fn, static_argnums=(0,), static_argnames=("mode",))


def model_batch(cfg, b, s, rng, decode=False):
    """A prefill / train batch (or a one-token decode batch) for any input
    mode, as numpy."""
    if cfg.input_mode == "embeddings":
        return {"embeddings": rng.standard_normal(
            (b, 1 if decode else s, cfg.d_model)).astype(np.float32)}
    if decode:
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, 1))
                .astype(np.int32)}
    n_img = cfg.num_image_tokens if cfg.input_mode == "tokens+image" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - n_img))
           .astype(np.int32)}
    if n_img:
        out["image_embeds"] = rng.standard_normal(
            (b, n_img, cfg.d_model)).astype(np.float32)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def reference_model(arch):
    """The JAX package's reduced ``arch``: config, params (numpy leaves)
    and a seeded batch of B x S."""
    cfg = jreduced(jget(arch))
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    batch = model_batch(cfg, B, S, np.random.default_rng(12))
    return dict(cfg=cfg, params=jax.tree_util.tree_map(np.asarray, params),
                batch=batch)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), **TOL)


def flat(tree, prefix=""):
    """{"a/b": leaf} of a tree of nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def close_trees(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).replace("torch.", "") == \
            str(np.asarray(want[k]).dtype), k
        close(got[k], want[k])


@functools.lru_cache(maxsize=None)
def served(arch):
    """Both packages' prefill over the reference batch (S tokens), then one
    decode step on a seeded next input from caches grown to CAPACITY."""
    ref = reference_model(arch)
    jc, jp = ref["cfg"], ref["params"]
    step = model_batch(jc, B, 1, np.random.default_rng(13), decode=True)
    j_logits, j_caches = jitted(JT.forward)(jc, jp, to_jax(ref["batch"]),
                                            mode="prefill")
    grown = JEngine(jc, jp, capacity=CAPACITY, batch=B)._grow_caches(
        j_caches, CAPACITY)
    j_dlogits, j_dcaches = jitted(JT.forward)(jc, jp, to_jax(step),
                                              mode="decode", caches=grown)

    cfg = reduced_config(get_config(arch))
    params = T.params_from_reference(cfg, jp, device="cpu")
    eng = ServeEngine(cfg, params, capacity=CAPACITY, batch=B, device="cpu")
    t_logits, t_caches = eng._prefill(params, to_torch(ref["batch"]))
    t_grown = eng._grow_caches(t_caches, CAPACITY)
    t_dlogits, t_dcaches = eng._decode(params, to_torch(step), t_grown)
    return dict(cfg=cfg, params=params, j_grown=grown,
                j=(j_logits, j_caches, j_dlogits, j_dcaches),
                t=(t_logits, t_caches, t_dlogits, t_dcaches))


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_equals_reference(arch):
    ref = reference_model(arch)
    jh, jaux = jitted(JT.forward)(ref["cfg"], ref["params"],
                                  to_jax(ref["batch"]), mode="train")
    cfg = reduced_config(get_config(arch))
    # the port's own init draws the reference's tree of shapes and dtypes
    own = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert _shapes(own) == _shapes(ref["params"])
    params = T.params_from_reference(cfg, ref["params"], device="cpu")
    h, aux = T.forward(cfg, params, to_torch(ref["batch"]), mode="train")
    assert h.dtype == torch.float32 and h.shape == jh.shape
    close(h, jh)
    close(aux, jaux)
    assert (float(aux) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_equal_reference(arch):
    r = served(arch)
    (j_logits, j_caches, _, _), (t_logits, t_caches, _, _) = r["j"], r["t"]
    assert t_logits.dtype == torch.float32
    assert tuple(t_logits.shape) == (B, r["cfg"].padded_vocab)
    close(t_logits, j_logits)
    assert t_caches["len"] == int(j_caches["len"]) == S
    close_trees(t_caches["layers"], j_caches["layers"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_equals_reference(arch):
    r = served(arch)
    (_, _, j_dlogits, j_dcaches), (_, _, t_dlogits, t_dcaches) = r["j"], r["t"]
    close(t_dlogits, j_dlogits)
    assert t_dcaches["len"] == int(j_dcaches["len"]) == S + 1
    close_trees(t_dcaches["layers"], j_dcaches["layers"])
    # the reference's grown caches, carried across, decode the same too
    cfg = r["cfg"]
    grown = T.caches_from_reference(cfg, r["j_grown"], device="cpu")
    step = model_batch(cfg, B, 1, np.random.default_rng(13), decode=True)
    logits, _ = T.forward(cfg, r["params"], to_torch(step), mode="decode",
                          caches=grown)
    close(logits, j_dlogits)
    # empty caches: the reference's init_caches, tree for tree
    want = JT.init_caches(cfg, B, CAPACITY, dtype=jnp.float32)
    got = T.init_caches(cfg, B, CAPACITY, dtype=torch.float32, device="cpu")
    assert got["len"] == int(want["len"]) == 0
    close_trees(got["layers"], want["layers"])


def _prompts(cfg, n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, length).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_engine_tokens_equal_reference_engine(arch):
    ref = reference_model(arch)
    jc, cfg = ref["cfg"], served(arch)["cfg"]
    prompts, news = _prompts(cfg, 2, 9, 14), (4, 6)
    want = JEngine(jc, ref["params"], capacity=32, batch=2).generate(
        [JRequest(prompt=p, max_new_tokens=n) for p, n in zip(prompts, news)])
    got = ServeEngine(cfg, served(arch)["params"], capacity=32, batch=2,
                      device="cpu").generate(
        [Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, news)])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert [len(r.out_tokens) for r in got] == list(news)


def test_serve_decode_matches_prefill():
    """Greedy tokens from the cache path == the argmax of a full prefill
    over the grown prompt at each step (the oracle of the reference's
    ``test_system.py::test_serve_decode_matches_prefill``)."""
    cfg = reduced_config(get_config("llama3.2-1b"), attn_chunk=16)
    params = T.params_from_reference(
        cfg, reference_model("llama3.2-1b")["params"], device="cpu")
    prompt = _prompts(cfg, 1, 9, 15)[0]
    eng = ServeEngine(cfg, params, capacity=32, batch=1, device="cpu")
    out = eng.generate([Request(prompt=prompt, max_new_tokens=4)])[0]
    toks, want = list(prompt), []
    for _ in range(4):
        logits, _ = T.forward(cfg, params, {"tokens": torch.tensor([toks])},
                              mode="prefill")
        want.append(int(logits[0, :cfg.vocab_size].argmax()))
        toks.append(want[-1])
    assert out.out_tokens == want


def test_decode_refuses_a_full_cache():
    """Where the port and the reference differ: a decode step past the
    cache's capacity. The reference's ``dynamic_update_slice`` clamps the
    write to the last slot and answers; the port raises."""
    r = served("llama3.2-1b")
    cfg, params = r["cfg"], r["params"]
    full = T.init_caches(cfg, B, S, dtype=torch.float32, device="cpu")
    full["len"] = S
    step = {"tokens": torch.zeros((B, 1), dtype=torch.int64)}
    with pytest.raises(ValueError, match="cache full"):
        T.forward(cfg, params, step, mode="decode", caches=full)
    jc = reference_model("llama3.2-1b")["cfg"]
    jfull = JT.init_caches(jc, B, S, dtype=jnp.float32)
    jfull["len"] = jnp.int32(S)
    logits, caches = jitted(JT.forward)(
        jc, reference_model("llama3.2-1b")["params"],
        {"tokens": jnp.zeros((B, 1), jnp.int32)}, mode="decode",
        caches=jfull)
    assert np.isfinite(np.asarray(logits)).all() and int(caches["len"]) == S + 1
    assert jax.device_get(caches["layers"]["attn"]["k"])[:, :, -1].any()
