"""Card-only checks of the port: the CUDA kernels against their plain
PyTorch versions, and the GC executor on the card against the CPU, bit
for bit. Every test skips where there is no NVIDIA GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import garble as G
from repro_torch.core.circuits import arith
from repro_torch.core.circuits.builder import CircuitBuilder
from repro_torch.kernels.level_eval import level_eval as LE
from repro_torch.kernels.level_eval import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have "
                    "no CPU mode; their plain versions are tested on the "
                    "CPU in test_torch_level_eval.py)")
    return torch.device("cuda")


def _operands(G_, seed):
    gen = torch.Generator().manual_seed(seed)
    words = lambda *s: torch.randint(-(1 << 31), 1 << 31, s,  # noqa: E731
                                     dtype=torch.int32, generator=gen)
    ops = (torch.arange(G_, dtype=torch.int32) % 4)[
        torch.randperm(G_, generator=gen)]
    r = words(1, 4)
    r[:, 0] |= 1
    return ops, words(G_, 4), words(G_, 4), words(G_, 4), words(G_, 4), \
        r.expand(G_, 4).contiguous(), words(G_)


@pytest.mark.parametrize("g", [1, 3001, 65_536 + 7])
def test_kernels_match_plain_version(cuda, g):
    ops, a, b, tg, te, r, tw = _operands(g, seed=g)
    LE.reset_launches()
    d = [x.to(cuda) for x in (ops, a, b, tg, te, r, tw)]
    got = LE.eval_level(d[0], d[1], d[2], d[3], d[4], d[6])
    gg = LE.garble_level(d[0], d[1], d[2], d[5], d[6])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.eval_level(ops, a, b, tg, te, tw))
    for x, y in zip(gg, ref.garble_level(ops, a, b, r, tw)):
        assert torch.equal(x.cpu(), y)
    assert (LE.eval_level.launches, LE.garble_level.launches) == (1, 1)


def test_wrapper_rejects_misaligned_labels(cuda):
    ops, a, b, tg, te, _, tw = (x.to(cuda) for x in _operands(9, seed=1))
    flat = a.reshape(-1)[1:33].reshape(8, 4)  # 4-byte offset
    with pytest.raises(ValueError, match="aligned"):
        LE.eval_level(ops[:8], flat, b[:8], tg[:8], te[:8], tw[:8])


def _cmp_net():
    cb = CircuitBuilder("cmp")
    x, y = cb.g_input_word(12), cb.e_input_word(12)
    lt = arith.lt_signed(cb, x, y)
    cb.output(arith.mux(cb, lt, x, y))
    cb.output(cb.INV(lt))
    return cb.build()


def _protocol_nets():
    from repro_torch.config import PrivacyConfig
    from repro_torch.core.protocol import PiTProtocol

    p = PiTProtocol(PrivacyConfig(), seed=0, device="cpu")
    return {"softmax2": p.softmax_net(2, 24),
            "gelu": p.activation_net("gelu", 24)}


@pytest.mark.parametrize("instances", [1, 16])
@pytest.mark.parametrize("name", ["cmp", "softmax2"])
def test_executor_on_card_matches_cpu(cuda, name, instances):
    net = _cmp_net() if name == "cmp" else _protocol_nets()[name]
    rng = np.random.default_rng(instances)
    gb = rng.integers(0, 2, (instances, len(net.garbler_inputs)))
    eb = rng.integers(0, 2, (instances, len(net.evaluator_inputs)))
    outs = []
    for dev in (cuda, "cpu"):
        gc = G.garble(net, torch.Generator().manual_seed(0), instances,
                      device=dev)
        labels = torch.cat([G.encode_inputs(gc, net.garbler_inputs, gb),
                            G.encode_inputs(gc, net.evaluator_inputs, eb)],
                           dim=1)
        wires = np.concatenate([net.garbler_inputs, net.evaluator_inputs])
        out = G.evaluate(net, gc.tables, (wires, labels))
        assert np.array_equal(G.decode_outputs(gc, out),
                              net.eval_plain(gb, eb))
        outs.append([t.cpu() for t in (gc.input_zero, gc.tables,
                                       gc.output_perm, out)])
    assert all(torch.equal(x, y) for x, y in zip(*outs))


# ---------------------------------------------------------------------------
# whole walks: the walk kernels against the plain walks
# ---------------------------------------------------------------------------

from repro_torch.core import gc_exec as X  # noqa: E402
from repro_torch.core.netlist import compile_level_plan  # noqa: E402


def _walk_operands(meta, instances, seed):
    gen = torch.Generator().manual_seed(seed)
    words = lambda *s: torch.randint(-(1 << 31), 1 << 31, s,  # noqa: E731
                                     dtype=torch.int32, generator=gen)
    store = words(meta.store_rows, instances, 4)
    r = words(instances, 4)
    r[:, 0] |= 1
    return store, r, words(meta.table_rows, instances, 4), \
        words(meta.table_rows, instances, 4)


def _walk_both(cuda, plan, instances, seed):
    """Each side's walk kernel and plain walk on the same random store
    and tables: (store, tables) from the card and from the CPU."""
    out = []
    for garble in (False, True):
        meta = X.pack_walk(plan, garble, "cpu")
        dmeta = meta._replace(records=meta.records.to(cuda))
        store, r, t1, t2 = _walk_operands(meta, instances, seed)
        if garble:
            store[-1] = r  # the R row
        d = [x.to(cuda) for x in (store, r, t1, t2)]
        if garble:
            LE.garble_walk(dmeta, d[0], d[1], d[2], d[3])
            ref.garble_walk(meta, store, r, t1, t2)
            res = [(d[0], store), (d[2], t1), (d[3], t2)]
        else:
            LE.eval_walk(dmeta, d[0], d[2], d[3])
            ref.eval_walk(meta, store, t1, t2)
            res = [(d[0], store)]
        torch.cuda.synchronize()
        out += [(x.cpu(), y) for x, y in res]
    return out


@pytest.mark.parametrize("instances", [1, 8, 4097])
@pytest.mark.parametrize("name", ["gelu", "softmax2"])
def test_walk_kernels_match_plain_walks(cuda, name, instances):
    net = _protocol_nets()[name]
    for garble in (False, True):
        plan = compile_level_plan(net, instances=instances, garbling=garble)
        LE.reset_launches()
        for got, want in _walk_both(cuda, plan, instances, seed=instances):
            assert torch.equal(got, want)
        assert (LE.eval_walk.launches, LE.garble_walk.launches) == (1, 1)
        assert (LE.eval_level.launches, LE.garble_level.launches) == (0, 0)


def test_walk_kernels_wide_lanes_and_clusters(cuda):
    """Chunks of 1,024 AND + 4,096 free lanes (the LayerNorm's latency
    widths: a 72 KB record, 224 KB of shared memory per block) split over
    a cluster of 8 blocks, and a cluster split at a ragged I."""
    net = _protocol_nets()["softmax2"]
    for (ca, cf), instances in (((1024, 4096), 8), ((64, 352), 3)):
        plan = compile_level_plan(net, and_width=ca, free_width=cf)
        shape = LE.walk_shape(ca, cf, X.pack_walk(plan, False, "cpu").stride,
                              instances)
        assert shape.cluster == (8 if ca == 1024 else 4), shape
        for got, want in _walk_both(cuda, plan, instances, seed=ca):
            assert torch.equal(got, want)


def test_keep_wires_garble_on_card_matches_cpu(cuda):
    """``keep_wires`` garbling (the append-only plan) through the garble
    walk kernel: every wire's zero-label as on the CPU."""
    net = _cmp_net()
    res = []
    for dev in (cuda, "cpu"):
        LE.reset_launches()
        gc = G.garble(net, torch.Generator().manual_seed(1), 5, device=dev,
                      keep_wires=True)
        assert LE.garble_walk.launches == (1 if dev == cuda else 0)
        res.append([t.cpu() for t in (gc.input_zero, gc.tables,
                                      gc.output_perm, gc.wire_zero)])
    assert all(torch.equal(x, y) for x, y in zip(*res))


def test_walk_wrapper_refuses_misaligned(cuda):
    net = _protocol_nets()["gelu"]
    meta = X.pack_walk(compile_level_plan(net, instances=2), False, cuda)
    store, _, t1, t2 = (x.to(cuda) for x in _walk_operands(meta, 2, 0))
    flat = torch.zeros(t1.numel() + 1, dtype=torch.int32, device=cuda)
    mis = flat[1:].view(t1.shape)
    with pytest.raises(ValueError, match="aligned"):
        LE.eval_walk(meta, store, mis, t2)


# ---------------------------------------------------------------------------
# NTT, label select and Half-Gate gate kernels; HE on the card
# ---------------------------------------------------------------------------

from repro_torch.config import PrivacyConfig  # noqa: E402
from repro_torch.core.protocol import PiTProtocol  # noqa: E402
from repro_torch.kernels.halfgate import halfgate as HK  # noqa: E402
from repro_torch.kernels.halfgate import ref as HR  # noqa: E402
from repro_torch.kernels.label_select import label_select as LS  # noqa: E402
from repro_torch.kernels.label_select import ref as LR  # noqa: E402
from repro_torch.kernels.ntt import ntt as NTT  # noqa: E402
from repro_torch.kernels.ntt import ref as NR  # noqa: E402


# row counts that are not a multiple of a block's rows (128 / (N / 16)
# rows per block below N = 2048)
@pytest.mark.parametrize("n,rows", [(8, 5), (256, 3), (2048, 7), (8192, 2),
                                    (2, 129), (4, 77), (16, 300), (64, 33),
                                    (512, 9), (1024, 3), (4096, 5),
                                    (16384, 3), (32768, 2), (32768, 5)])
def test_ntt_kernel_matches_plain_version(cuda, n, rows):
    qs = NR.find_ntt_primes(30, 3, n)
    rng = np.random.default_rng(n)
    a = torch.from_numpy(np.stack([rng.integers(0, q, (rows, n)) for q in qs]))
    cases = [(qs, a)]
    if n <= 2048:  # no prime = 1 mod 2N below 46340 for larger N
        limb = NR.find_ntt_primes(16, 1, n, max_q=NR.INT32_PRODUCT_BOUND)[0]
        cases.append((limb, a[0] % limb))
    # the largest NTT prime below 2^31: sums of two residues need all 32 bits
    q31 = NR.find_ntt_primes(31, 1, n)[0]
    cases.append((q31, torch.from_numpy(rng.integers(0, q31, (rows, n)))))
    NTT.reset_launches()
    for q, x in cases:
        d = x.to(cuda)
        f = NTT.ntt_forward(d, q)
        i = NTT.ntt_inverse(d, q)
        torch.cuda.synchronize()
        assert torch.equal(f.cpu(), NR.ntt_forward(x, q))
        assert torch.equal(i.cpu(), NR.ntt_inverse(x, q))
        assert torch.equal(NTT.ntt_inverse(f, q).cpu(), x)
    per_call = 2 if n > NTT.MAX_ROW_N else 1  # top stage + in-block kernel
    assert (NTT.ntt_forward.launches, NTT.ntt_inverse.launches) == \
        (per_call * len(cases), 2 * per_call * len(cases))


def test_ntt_wrapper_refusals(cuda):
    q = NR.find_ntt_primes(30, 1, 256)[0]
    x = torch.zeros((4, 256), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int64"):
        NTT.ntt_forward(x.int(), q)
    with pytest.raises(ValueError, match="contiguous"):
        NTT.ntt_forward(x.t().contiguous().t(), q)
    with pytest.raises(ValueError, match="power of two"):
        NTT.ntt_forward(torch.zeros((1, 2 * NTT.MAX_N), dtype=torch.int64,
                                    device=cuda), q)
    with pytest.raises(ValueError, match="2\\^31"):
        NTT.ntt_forward(x, 2 ** 31 + 513)
    # an 8-byte offset: the kernel moves rows as 16-byte vectors
    flat = torch.zeros(4 * 256 + 1, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        NTT.ntt_forward(flat[1:].view(4, 256), q)


@pytest.mark.parametrize("lead,r_lead", [((4097,), (4097,)), ((3, 1001), (3, 1)),
                                         ((5, 7), (1, 1))])
def test_label_select_kernel_matches_plain_version(cuda, lead, r_lead):
    gen = torch.Generator().manual_seed(sum(lead))
    words = lambda *s: torch.randint(-(1 << 31), 1 << 31, s,  # noqa: E731
                                     dtype=torch.int32, generator=gen)
    w0, r = words(*lead, 4), words(*r_lead, 4)
    bits = torch.randint(0, 2, lead, generator=gen)
    LS.reset_launches()
    got = LS.select_labels(w0.to(cuda), r.to(cuda), bits.numpy())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), LR.select_labels(w0, r, bits))
    assert LS.select_labels.launches == 1


def test_label_select_refuses_misaligned(cuda):
    w = torch.zeros(40, dtype=torch.int32, device=cuda)[1:33].view(8, 4)
    with pytest.raises(ValueError, match="aligned"):
        LS.select_labels(w, w, np.zeros(8))


@pytest.mark.parametrize("g", [1, 3001, 196_608 + 5])
def test_halfgate_gate_kernels_match_plain_version(cuda, g):
    _, a, b, tg, te, r, tw = _operands(g, seed=g + 1)
    HK.reset_launches()
    d = [x.to(cuda) for x in (a, b, tg, te, r, tw)]
    gg = HK.garble_gates(d[0], d[1], d[4], d[5])
    ev = HK.eval_gates(d[0], d[1], d[2], d[3], d[5])
    torch.cuda.synchronize()
    for x, y in zip(gg, HR.garble_and_gates(a, b, r, tw)):
        assert torch.equal(x.cpu(), y)
    assert torch.equal(ev.cpu(), HR.eval_and_gates(a, b, tg, te, tw))
    assert (HK.garble_gates.launches, HK.eval_gates.launches) == (1, 1)


@pytest.mark.parametrize("d_in,d_out", [(64, 48), (768, 5)])
def test_he_linear_offline_on_card_matches_cpu(cuda, d_in, d_out):
    W = np.random.default_rng(d_in).normal(0, 0.05, (d_out, d_in))
    res = []
    for dev in (cuda, "cpu"):
        p = PiTProtocol(PrivacyConfig(frac_bits=6), seed=3, device=dev)
        NTT.reset_launches()
        corr = p.linear_offline(W, (d_in,), use_he_offline=True)
        launches = NTT.ntt_forward.launches + NTT.ntt_inverse.launches
        assert launches == (6 if dev == cuda else 0)  # enc, matvec, dec
        res.append((p.sk.cpu(), *(x.cpu() for x in p.pk), corr.client_y,
                    corr.r1, corr.s_mask, p.stats.comm_snapshot()))
    k, c = res
    assert all(torch.equal(x, y) for x, y in zip(k[:3], c[:3]))
    assert all(np.array_equal(x, y) for x, y in zip(k[3:6], c[3:6]))
    assert k[6] == c[6]


def test_protocol_keygen_at_16384_on_card_matches_cpu(cuda):
    """A ring of 16384 (above one block's longest row before the split
    path) generates the same keys on the card as on the CPU."""
    keys = []
    for dev in (cuda, "cpu"):
        NTT.reset_launches()
        p = PiTProtocol(PrivacyConfig(he_poly_n=16384), seed=5, device=dev)
        torch.cuda.synchronize()
        assert (NTT.ntt_forward.launches > 0) == (dev == cuda)
        keys.append((p.sk.cpu(), *(x.cpu() for x in p.pk)))
    assert all(torch.equal(x, y) for x, y in zip(*keys))
