"""The port's negacyclic NTT (plain PyTorch version, through the kernel
wrappers on the CPU) against the JAX package's: its jnp oracle at ~30-bit
primes, its Pallas kernel in interpret mode at a limb prime, and the
O(N^2) oracle. Tolerance 0: residues are integers."""

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


@pytest.mark.parametrize("n", [8, 256, 2048])
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
