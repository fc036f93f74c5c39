"""The port's negacyclic NTT (plain PyTorch version, through the kernel
wrappers on the CPU) against the JAX package's: its jnp oracle at ~30-bit
primes, its Pallas kernel in interpret mode at a limb prime, and the
O(N^2) oracle. The CUDA kernel's host-built Shoup tables, its 32-bit
products and a model of its schedule (``ref.kernel_model``) against
Python integers and the plain version. Tolerance 0: residues are
integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ntt import ref as JR
from repro.kernels.ntt.ntt import ntt_pallas
from repro_torch.kernels.ntt import ntt as TN
from repro_torch.kernels.ntt import ref as TR


def _residues(seed, qs, shape):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, q, shape) for q in qs])


def test_parameter_search_matches_reference():
    for bits, count, n in ((30, 3, 2048), (30, 4, 256), (26, 5, 256),
                           (16, 1, 64)):
        assert TR.find_ntt_primes(bits, count, n) == \
            JR.find_ntt_primes(bits, count, n)
    q = JR.find_ntt_primes(30, 1, 256)[0]
    assert TR.find_primitive_root(q, 512) == JR.find_primitive_root(q, 512)
    for want, got in zip(JR.ntt_tables(q, 256), TR.ntt_tables(q, 256)):
        assert np.array_equal(np.asarray(want, np.int64), got)


@pytest.mark.parametrize("n", [8, 256, 2048, 16384, 32768])
def test_forward_inverse_match_reference_at_30_bit_primes(n):
    qs = JR.find_ntt_primes(30, 3, n)
    a = _residues(n, qs, (2, n))  # (P, rows, n): one batch over 3 primes
    fwd = TN.ntt_forward(torch.from_numpy(a), qs)
    inv = TN.ntt_inverse(torch.from_numpy(a), qs)
    for i, q in enumerate(qs):
        x = jnp.asarray(a[i].astype(np.uint64))
        assert np.array_equal(fwd[i].numpy(),
                              np.asarray(JR.ntt_forward(x, q, n), np.int64))
        assert np.array_equal(inv[i].numpy(),
                              np.asarray(JR.ntt_inverse(x, q, n), np.int64))
        # one prime at a time through the single-prime form
        assert torch.equal(TN.ntt_forward(torch.from_numpy(a[i]), q), fwd[i])
    assert np.array_equal(TN.ntt_inverse(fwd, qs).numpy(), a)


@pytest.mark.parametrize("n", [8, 256, 2048])
def test_negacyclic_mul_matches_reference(n):
    qs = JR.find_ntt_primes(30, 3, n)
    a, b = _residues(1, qs, (n,)), _residues(2, qs, (n,))
    got = TN.negacyclic_mul(torch.from_numpy(a), torch.from_numpy(b), qs)
    for i, q in enumerate(qs):
        want = JR.negacyclic_mul(jnp.asarray(a[i].astype(np.uint64)),
                                 jnp.asarray(b[i].astype(np.uint64)), q, n)
        assert np.array_equal(got[i].numpy(), np.asarray(want, np.int64))


@pytest.mark.parametrize("n", [64, 256])
def test_matches_pallas_kernel_at_limb_prime(n):
    q = TR.find_ntt_primes(16, 1, n, max_q=TR.INT32_PRODUCT_BOUND)[0]
    assert q <= JR.INT32_PRODUCT_BOUND
    a = np.random.default_rng(n).integers(0, q, (3, n))
    fwd = ntt_pallas(jnp.asarray(a, jnp.int32), q, n, interpret=True)
    got = TN.ntt_forward(torch.from_numpy(a), q)
    assert np.array_equal(got.numpy(), np.asarray(fwd, np.int64))
    back = ntt_pallas(fwd, q, n, inverse=True, interpret=True)
    assert np.array_equal(TN.ntt_inverse(got, q).numpy(),
                          np.asarray(back, np.int64))


@pytest.mark.parametrize("n,q_bits", [(64, 30), (128, 13)])
def test_negacyclic_mul_matches_naive_oracle(n, q_bits):
    q = TR.find_ntt_primes(q_bits, 1, n)[0]
    rng = np.random.default_rng(q_bits)
    a, b = rng.integers(0, q, n), rng.integers(0, q, n)
    fast = TN.negacyclic_mul(torch.from_numpy(a), torch.from_numpy(b), q)
    assert np.array_equal(fast.numpy(), TR.negacyclic_mul_naive(a, b, q, n))
    assert np.array_equal(fast.numpy(),
                          JR.negacyclic_mul_naive(a, b, q, n).astype(np.int64))


def test_rejects_what_the_kernel_cannot_take():
    n = 256
    big = 2 ** 31 + 2 * n * 4 + 1  # 1 mod 2N, but products overflow int64
    with pytest.raises(ValueError, match="2\\^31"):
        TR.check_prime(big, n)
    with pytest.raises(ValueError, match="1 mod 2N"):
        TR.check_prime(JR.find_ntt_primes(30, 1, 128)[0] + 2, n)
    with pytest.raises(ValueError, match="power of two"):
        TR.check_prime(12289, 96)
    q = JR.find_ntt_primes(30, 2, n)
    x = torch.zeros((2, n), dtype=torch.int64)
    with pytest.raises(TypeError, match="int64"):
        TN.ntt_forward(x.to(torch.int32), q)
    with pytest.raises(ValueError, match="leading dimension"):
        TN.ntt_forward(torch.zeros((3, n), dtype=torch.int64), q)
    assert TN.ntt_forward.launches == 0  # the CPU runs the plain version


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic and schedule, on the CPU
# ---------------------------------------------------------------------------

HE_PRIMES = (1073692673, 1073668097, 1073655809)
#: the largest NTT primes below 2^31 at N = 8, 2048, 8192 (and at 16384
#: and 32768, where it is the same prime as at 8192)
Q31 = {8: 2147483489, 2048: 2147389441, 8192: 2147352577,
       16384: 2147352577, 32768: 2147352577}


def test_named_primes_are_the_parameter_search_s():
    assert tuple(TR.find_ntt_primes(30, 3, 2048)) == HE_PRIMES
    for n, q in Q31.items():
        assert TR.find_ntt_primes(31, 1, n) == [q]


@pytest.mark.parametrize("qs,n", [(HE_PRIMES, 2048), ((40961,), 2048),
                                  ((Q31[8],), 8), ((Q31[2048],), 2048),
                                  ((Q31[8192],), 8192)])
@pytest.mark.parametrize("inverse", [False, True])
def test_device_tables_shoup_companions(qs, n, inverse):
    table, consts = TN.device_tables(qs, n, inverse, torch.device("cpu"))
    assert table.shape == (len(qs), n, 2) and table.dtype == torch.int32
    assert consts.shape == (len(qs), 8) and consts.dtype == torch.int32
    table = table.numpy().view(np.uint32)
    consts = consts.numpy().view(np.uint32)
    for i, q in enumerate(qs):
        psi, ipsi, n_inv = JR.ntt_tables(q, n)
        w = [int(v) for v in (ipsi if inverse else psi)]
        assert [int(v) for v in table[i, :, 0]] == w
        assert [int(v) for v in table[i, :, 1]] == [(v << 32) // q for v in w]
        last = w[1] * n_inv % q
        assert [int(v) for v in consts[i]] == [
            q, n_inv, (n_inv << 32) // q, last, (last << 32) // q, 0, 0, 0]


@pytest.mark.parametrize("q", [*HE_PRIMES, 40961, *Q31.values()])
def test_shoup_product_is_exact_in_32_bits(q):
    rng = np.random.default_rng(q)
    a = np.concatenate([[0, q - 1, 2 ** 32 - 1],
                        rng.integers(0, 2 ** 32, 997)]).astype(np.uint64)
    for w in (0, 1, q - 1, *rng.integers(0, q, 5)):
        wp = TR.shoup_companion(w, q)
        assert int(wp) == (int(w) << 32) // q
        got = TR.shoup_mul32(a, np.uint64(w), wp, q)
        assert got.max() < 2 ** 32
        assert [int(v) for v in got] == [int(x) * int(w) % q for x in a]


@pytest.mark.parametrize("n", [2, 8, 256, 2048, 8192, 16384, 32768])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_schedule_model_matches_plain_version(n, inverse):
    """The model of csrc/ntt.cu (its rounds, register and thread index
    mapping, swizzled exchanges, twiddle indices and 32-bit arithmetic)
    against the plain version, bit for bit: the HE-sized primes over a
    row count that is not a multiple of a block's rows, and the largest
    prime below 2^31 with every residue at q - 1 in one row. At N = 32768
    the model also replays the top-stage pass and the two sub-rows of
    16384, whose twiddles come from the whole row's table."""
    qs = TR.find_ntt_primes(30, 3, n)
    _, _, rpb = TR.kernel_shape(n)
    a = _residues(n + inverse, qs, (rpb + 1, n))
    plain = TR.ntt_inverse if inverse else TR.ntt_forward
    got, exchanges = TR.kernel_model(torch.from_numpy(a), qs, inverse)
    assert torch.equal(got, plain(torch.from_numpy(a), qs))
    q31 = TR.find_ntt_primes(31, 1, n)[0]
    b = np.random.default_rng(n).integers(0, q31, (3, n))
    b[1] = q31 - 1
    got, _ = TR.kernel_model(torch.from_numpy(b), q31, inverse)
    assert torch.equal(got, plain(torch.from_numpy(b), q31))
    # stages merged in registers: 16 per thread from n = 16, so a row
    # of 2048 makes 3 exchanges instead of 11 passes
    assert len(exchanges) == {2: 0, 8: 0, 256: 2, 2048: 3, 8192: 4,
                              16384: 4, 32768: 4}[n]


@pytest.mark.parametrize("n", [512, 2048, 8192, 16384])
def test_kernel_exchanges_are_bank_conflict_free(n):
    log_r, lt, rpb = TR.kernel_shape(n)
    threads = rpb << lt
    t = np.arange(threads) & ((1 << lt) - 1)
    rib = np.arange(threads) >> lt
    x = torch.zeros((1, n), dtype=torch.int64)
    for inverse in (False, True):
        _, exchanges = TR.kernel_model(x, TR.find_ntt_primes(30, 1, n)[0],
                                       inverse)
        for layout in {lay for ex in exchanges for lay in ex}:
            for words in TR.kernel_addresses(n, layout, t, rib):
                banks = np.broadcast_to(words, t.shape).reshape(-1, 32) & 31
                assert all(len(set(w)) == 32 for w in banks), (n, layout)


def test_rows_longer_than_a_block_split_in_two():
    """N = 32768 runs as a top-stage pass and two sub-rows of 16384 whose
    twiddle roots are 2 and 3 (the twiddle trap: a sub-row is not an NTT
    of its own length, so the plain NTT of length 16384 differs)."""
    assert [TR.kernel_split(n) for n in (8192, 16384, 32768)] == [0, 0, 1]
    assert TR.kernel_shape(32768) == TR.kernel_shape(16384) == (4, 10, 1)
    assert TN.MAX_N == 32768 and TN.MAX_ROW_N == 16384
    qs = TR.find_ntt_primes(30, 3, 32768)
    a = torch.from_numpy(_residues(5, qs, (1, 32768)))
    got, _ = TR.kernel_model(a, qs, False)
    assert torch.equal(got, TR.ntt_forward(a, qs))
    half = TR.ntt_forward(a[..., :16384].contiguous(), qs)
    assert not torch.equal(got[..., :16384], half)
