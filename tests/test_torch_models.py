"""The port's model plane against the JAX package's, layer by layer, at
f32 on the CPU (whole models are in ``test_torch_model_serve.py``).

Inputs come from numpy with a seed; weights from the JAX package's init
functions, carried across as numpy. Tolerance: both sides compute in f32
and differ only in the order of sums (einsum contraction paths, the
chunked scans), so ``TOL`` (1e-4 relative and absolute) holds every
comparison; the largest error measured on these inputs was 2.5e-5 at a
magnitude of 10 (the Mamba2 state)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget
from repro.config import reduced_config as jreduced
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch.config import get_config, reduced_config
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import sharding
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-4)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), **(tol or TOL))


def pair(a):
    """One numpy array as (jax array, torch tensor)."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def jitted(fn):
    """A reference function compiled whole (config and mode static): one
    XLA compile instead of one per eager op keeps these tests short."""
    return jax.jit(fn, static_argnums=(0,), static_argnames=("mode",))


def cfgs(arch, **over):
    return (jreduced(jget(arch), **over), reduced_config(get_config(arch),
                                                         **over))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S_,chunk", [(50, 16), (64, 16), (24, 64)])
def test_flash_chunks_equal_reference(causal, S_, chunk):
    jc, tc = cfgs("llama3.2-1b", attn_chunk=chunk)
    assert tc.num_heads // tc.num_kv_heads == 4  # GQA
    rng = np.random.default_rng(S_ + chunk)
    B, H, KV, hd = 2, tc.num_heads, tc.num_kv_heads, tc.head_dim
    (jq, tq), (jk, tk), (jv, tv) = (
        pair(rng.standard_normal(s).astype(np.float32))
        for s in ((B, S_, H, hd), (B, S_, KV, hd), (B, S_, KV, hd)))
    want = jax.jit(JL._flash_chunks, static_argnums=(0, 5))(
        jc, jq, jk, jv, 0, causal)
    close(L._flash_chunks(tc, tq, tk, tv, 0, causal), want)


def test_decode_attention_equals_reference():
    jc, tc = cfgs("qwen3-1.7b")
    rng = np.random.default_rng(5)
    B, T_, H, KV, hd = 3, 20, tc.num_heads, tc.num_kv_heads, tc.head_dim
    (jq, tq), (jk, tk), (jv, tv) = (
        pair(rng.standard_normal(s).astype(np.float32))
        for s in ((B, 1, H, hd), (B, T_, KV, hd), (B, T_, KV, hd)))
    for n in (0, 7, T_ - 1):
        close(L._decode_attn(tc, tq, tk, tv, n),
              JL._decode_attn(jc, jq, jk, jv, jnp.int32(n)))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b"])
def test_attention_block_modes_equal_reference(arch):
    """``attention`` in train, prefill and decode (the cache write at
    ``cache["len"]``), with qk-norm (qwen3) and the per-use LoRA (zamba2)."""
    jc, tc = cfgs(arch)
    key = jax.random.PRNGKey(1)
    jp = JL.init_attention(key, jc)
    if jc.qk_norm:
        jp["qn"]["scale"] = jnp.linspace(0.5, 1.5, jc.head_dim)
    lora = None
    if jc.shared_attn_lora_rank:
        lora = JL.init_attention_lora(key, jc, jc.shared_attn_lora_rank)
        lora["lora_b"]["w"] = jax.random.normal(key, lora["lora_b"]["w"].shape)
    tp = T.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    tl = None if lora is None else T.tree_map(
        lambda a: torch.from_numpy(np.array(a)), lora)
    attn = jax.jit(JL.attention, static_argnums=(0,),
                   static_argnames=("mode",))
    rng = np.random.default_rng(6)
    jx, tx = pair(rng.standard_normal((2, 9, jc.d_model)).astype(np.float32))
    for mode in ("train", "prefill"):
        jy, jcache = attn(jc, jp, jx, pos_offset=0, mode=mode, lora=lora)
        ty, tcache = L.attention(tc, tp, tx, pos_offset=0, mode=mode, lora=tl)
        close(ty, jy)
    close(tcache["k"], jcache["k"])
    assert tcache["len"] == int(jcache["len"]) == 9
    cap = np.zeros((2, 12, jc.num_kv_heads, jc.head_dim), np.float32)
    cap[:, :9] = np.asarray(jcache["k"])
    capv = np.zeros_like(cap)
    capv[:, :9] = np.asarray(jcache["v"])
    jd, td = pair(rng.standard_normal((2, 1, jc.d_model)).astype(np.float32))
    jy, jn = attn(jc, jp, jd, pos_offset=jnp.int32(9), mode="decode",
                  cache={"k": jnp.asarray(cap), "v": jnp.asarray(capv),
                         "len": jnp.int32(9)}, lora=lora)
    given = {"k": torch.from_numpy(cap.copy()),
             "v": torch.from_numpy(capv.copy()), "len": 9}
    ty, tn = L.attention(tc, tp, td, pos_offset=9, mode="decode",
                         cache=given, lora=tl)
    close(ty, jy)
    close(tn["k"], jn["k"])
    close(tn["v"], jn["v"])
    assert tn["len"] == int(jn["len"]) == 10
    assert torch.equal(given["k"], torch.from_numpy(cap))  # not written


def test_rope_and_norms_equal_reference():
    jc, tc = cfgs("llama3.2-1b")
    rng = np.random.default_rng(7)
    jx, tx = pair(rng.standard_normal((2, 11, 4, tc.head_dim))
                  .astype(np.float32) * 3)
    for off in (0, 200):
        pos = np.arange(11) + off
        jcos, jsin = JL.rope_freqs(jc, jnp.asarray(pos, jnp.int32))
        tcos, tsin = L.rope_freqs(tc, torch.from_numpy(pos))
        close(tcos, jcos)
        close(tsin, jsin)
        close(L.apply_rope(tx, tcos[None, :, None], tsin[None, :, None]),
              JL.apply_rope(jx, jcos[None, :, None], jsin[None, :, None]))
    scale = rng.standard_normal(tc.head_dim).astype(np.float32)
    close(L.rms_head_norm(torch.from_numpy(scale), tx),
          JL.rms_head_norm(jnp.asarray(scale), jx))
    for kind in ("rmsnorm", "layernorm"):
        jn = dataclasses.replace(jc, norm_type=kind)
        p = {"scale": rng.standard_normal(tc.head_dim).astype(np.float32),
             "bias": rng.standard_normal(tc.head_dim).astype(np.float32)}
        close(L.apply_norm(dataclasses.replace(tc, norm_type=kind),
                           {k: torch.from_numpy(v) for k, v in p.items()}, tx),
              JL.apply_norm(jn, {k: jnp.asarray(v) for k, v in p.items()}, jx))


def test_embed_and_unembed_equal_reference():
    rng = np.random.default_rng(16)
    table = rng.standard_normal((40, 12)).astype(np.float32)
    toks = rng.integers(0, 40, (2, 7))
    jx, tx = pair(rng.standard_normal((2, 7, 12)).astype(np.float32))
    jp, tp = {"table": jnp.asarray(table)}, {"table": torch.from_numpy(table)}
    close(L.embed(tp, torch.from_numpy(toks), torch.float32),
          JL.embed(jp, jnp.asarray(toks, jnp.int32), jnp.float32))
    close(L.unembed(tp, tx), JL.unembed(jp, jx))
    got = L.unembed(tp, tx.to(torch.bfloat16))  # bf16 operands, f32 sums
    assert got.dtype == torch.float32
    close(got, JL.unembed(jp, jx.astype(jnp.bfloat16)).astype(jnp.float32))


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("gelu", True)])
def test_mlp_equals_reference(act, gated):
    jc, tc = (dataclasses.replace(c, activation=act, gated_mlp=gated)
              for c in cfgs("smollm-360m"))
    jp = JL.init_mlp(jax.random.PRNGKey(2), jc)
    tp = T.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    jx, tx = pair(np.random.default_rng(8).standard_normal(
        (2, 5, jc.d_model)).astype(np.float32) * 2)
    close(L.mlp(tc, tp, tx), JL.mlp(jc, jp, jx))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-a16e"])
def test_router_and_dense_moe_equal_reference(arch):
    jc, tc = cfgs(arch)
    jp = JM.init_moe(jax.random.PRNGKey(3), jc)
    tp = T.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    jx, tx = pair(np.random.default_rng(9).standard_normal(
        (2, 13, jc.d_model)).astype(np.float32))
    jg, ji, ja = jax.jit(JM._router, static_argnums=0)(jc, jp, jx)
    tg, ti, ta = M._router(tc, tp, tx)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    close(tg, jg)
    close(ta, ja)
    jy, jaux = jax.jit(JM.moe_ffn, static_argnums=0)(jc, jp, jx)
    ty, taux = M.moe_ffn(tc, tp, tx)
    close(ty, jy)
    close(taux, jaux)
    assert sharding.active_rules() is None  # a2a configs take the dense path


def test_sharding_is_the_identity_on_one_device():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import AbstractMesh

    x = torch.ones(2, 3)
    assert sharding.shard(x, "batch", None) is x
    assert sharding.axis_size_of("attn_seq") == 1
    rules = sharding.Rules(mesh=AbstractMesh((2, 4), ("data", "model")),
                           table={"batch": ("data",), "heads": ("model",)})
    with sharding.use_rules(rules):
        assert sharding.active_rules() is rules
        assert sharding.axis_size_of("heads") == 4
        assert sharding.axis_size_of("vocab") == 1
        # under rules ``shard`` lays tensors out as DTensors with these
        # placements (run on ranks in tests/test_torch_mesh_ranks.py)
        spec = rules.spec("batch", None, "heads")
        assert tuple(spec) == ("data", None, "model")
        assert sharding.placements(spec, rules.mesh) == [Shard(0), Shard(2)]
        assert sharding.placements(rules.spec(None, "vocab"), rules.mesh) \
            == [Replicate(), Replicate()]
    assert sharding.active_rules() is None


def _rnn_inputs(rng, B, Lh, H, N, P, decay=0.3):
    f = np.float32
    return (rng.standard_normal((B, Lh, H, N)).astype(f),
            rng.standard_normal((B, Lh, H, N)).astype(f),
            rng.standard_normal((B, Lh, H, P)).astype(f),
            (-np.abs(rng.standard_normal((B, Lh, H))) * decay).astype(f))


def test_chunked_linear_rnn_and_step_equal_reference():
    rng = np.random.default_rng(10)
    ins = _rnn_inputs(rng, 2, 32, 3, 4, 5)
    j_ins = [jnp.asarray(a) for a in ins]
    t_ins = [torch.from_numpy(a) for a in ins]
    rnn = jax.jit(JS.chunked_linear_rnn, static_argnames=("chunk",))
    jy, js = rnn(*j_ins, chunk=8)
    ty, ts = S.chunked_linear_rnn(*t_ins, chunk=8)
    close(ty, jy)
    close(ts, js)
    # state chaining: two calls with the carried state == one call
    h = 16
    ty1, ts1 = S.chunked_linear_rnn(*(a[:, :h] for a in t_ins), chunk=8)
    ty2, ts2 = S.chunked_linear_rnn(*(a[:, h:] for a in t_ins), chunk=8,
                                    initial_state=ts1)
    close(torch.cat([ty1, ty2], 1), jy)
    close(ts2, js)
    jy2, js2 = rnn(*(a[:, h:] for a in j_ins), chunk=8, initial_state=js)
    ty2, ts2 = S.chunked_linear_rnn(*(a[:, h:] for a in t_ins), chunk=8,
                                    initial_state=ts)
    close(ty2, jy2)
    close(ts2, js2)
    # one step of the recurrence
    state = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    jy, js = jax.jit(JS.linear_rnn_step)(*(a[:, 0] for a in j_ins),
                                         jnp.asarray(state))
    ty, ts = S.linear_rnn_step(*(a[:, 0] for a in t_ins),
                               torch.from_numpy(state))
    close(ty, jy)
    close(ts, js)


def _block_train_decode(jfn, tfn, jc, tc, jp, L_=32):
    """A block in train mode over L_ tokens, then prefill on L_ and one
    decode step from the reference's decode cache, both packages."""
    tp = T.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    jfn = jitted(jfn)
    rng = np.random.default_rng(11)
    jx, tx = pair(rng.standard_normal((2, L_, jc.d_model)).astype(np.float32))
    jy, _ = jfn(jc, jp, jx, mode="train")
    ty, _ = tfn(tc, tp, tx, mode="train")
    close(ty, jy)
    jy, jcache = jfn(jc, jp, jx, mode="prefill")
    ty, tcache = tfn(tc, tp, tx, mode="prefill")
    close(ty, jy)
    for k in jcache:
        close(tcache[k], jcache[k])
    jd, td = pair(rng.standard_normal((2, 1, jc.d_model)).astype(np.float32))
    jy, jn = jfn(jc, jp, jd, cache=jcache, mode="decode")
    ty, tn = tfn(tc, tp, td, mode="decode", cache=T.tree_map(
        lambda a: torch.from_numpy(np.array(a)), jcache))
    close(ty, jy)
    for k in jn:
        close(tn[k], jn[k])


def test_mamba2_equals_reference():
    jc, tc = cfgs("zamba2-2.7b")
    jp = JS.init_mamba2(jax.random.PRNGKey(4), jc)
    _block_train_decode(JS.mamba2, S.mamba2, jc, tc, jp, L_=64)


def test_mlstm_equals_reference():
    jc, tc = cfgs("xlstm-125m")
    jp = JS.init_mlstm(jax.random.PRNGKey(5), jc)
    _block_train_decode(JS.mlstm, S.mlstm, jc, tc, jp)


def test_slstm_equals_reference():
    jc, tc = cfgs("xlstm-125m")
    jp = JS.init_slstm(jax.random.PRNGKey(6), jc)
    _block_train_decode(JS.slstm, S.slstm, jc, tc, jp, L_=12)
