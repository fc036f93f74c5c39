// Negacyclic NTT and inverse NTT over Z_q[X]/(X^N+1), on the H100.
//
// Replaces the JAX package's Pallas kernel
//   kernels/ntt/ntt.py:89  ntt_pallas  (bodies _fwd_kernel, _inv_kernel)
// with the same transform (Longa–Naehrig butterflies, merged bit-reversed
// psi tables, the inverse ending with the n^-1 scale), but for any prime
// q < 2^31 rather than the TPU kernel's int32 limb primes (q <= 46340):
// residues are read and written as int64, each product of two residues is
// a 64-bit integer below 2^62, and it is reduced by Barrett's method with
// mu = floor(2^64 / q) (one __umul64hi, one multiply-subtract and at most
// two conditional subtractions; exact for every product below 2^64).
//
// Layout: `rows` polynomials of length n, row-major; the first
// rows_per_prime rows are taken mod primes[0], the next mod primes[1], and
// so on, so one launch covers every RNS limb of a batch. The psi tables are
// (P, n) int32, the per-prime constants (P, 3) int64: q, mu, n^-1.
//
// Design: one thread block per row. The row is loaded once into shared
// memory as 32-bit residues (n = 2048 takes 8 KB), all log2(n) stages run
// there with __syncthreads() between stages, and the row is written once:
// device memory sees one read and one write per coefficient, as the Pallas
// kernel's VMEM-resident rows do. Twiddles are read from the table in
// global memory (L2-resident: 8 KB per prime).
//
// What bounds it on the H100, per butterfly: one 64-bit multiply, its
// Barrett reduction and a modular add and subtract, counted as 8 64-bit
// integer operations; per coefficient, 16 bytes (an int64 read and an int64
// write). Counted at one 64-bit operation per int32 lane-cycle (a lower
// bound: a 64-bit multiply takes several 32-bit instructions), n = 2048
// moves 16 B per coefficient against 8 * 11 / 2 = 44 operations, so the
// bound is the bytes (3.35 TB/s) by a factor of about two.
//
// The C entry point returns cudaErrorInvalidValue for a length it does not
// take, otherwise cudaGetLastError() after the launch; the Python wrapper
// raises on anything but cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 8192;  // 32 KB of shared memory per row
constexpr int kMaxThreads = 512;

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b, uint64_t q,
                                           uint64_t mu) {
  const uint64_t x = (uint64_t)a * b;
  const uint64_t qhat = __umul64hi(x, mu);
  uint64_t r = x - qhat * q;
  r = r >= q ? r - q : r;
  r = r >= q ? r - q : r;
  return (uint32_t)r;
}

__device__ __forceinline__ uint32_t addmod(uint32_t u, uint32_t v, uint32_t q) {
  const uint32_t s = u + v;  // < 2^32: both below q < 2^31
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t submod(uint32_t u, uint32_t v, uint32_t q) {
  return u >= v ? u - v : u + q - v;
}

__global__ void ntt_kernel(const int64_t* __restrict__ in,
                           int64_t* __restrict__ out,
                           const int32_t* __restrict__ table,
                           const int64_t* __restrict__ consts,
                           long long rows_per_prime, int n, int log_n,
                           int inverse) {
  extern __shared__ uint32_t x[];
  const long long row = blockIdx.x;
  const long long p = row / rows_per_prime;
  const uint64_t q = (uint64_t)consts[3 * p];
  const uint64_t mu = (uint64_t)consts[3 * p + 1];
  const uint32_t* psi = (const uint32_t*)(table + p * n);
  const int64_t* src = in + row * n;
  int64_t* dst = out + row * n;
  const int half = n >> 1;

  for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = (uint32_t)src[i];
  __syncthreads();

  if (!inverse) {
    // stage with m groups of 2t: butterfly k -> group k / t, lane k % t
    for (int s = 0; s < log_n; ++s) {
      const int m = 1 << s;
      const int lt = log_n - 1 - s;  // t = 2^lt
      for (int k = threadIdx.x; k < half; k += blockDim.x) {
        const int g = k >> lt;
        const int j = (g << (lt + 1)) + (k & ((1 << lt) - 1));
        const uint32_t u = x[j];
        const uint32_t v = mulmod(x[j + (1 << lt)], psi[m + g], q, mu);
        x[j] = addmod(u, v, (uint32_t)q);
        x[j + (1 << lt)] = submod(u, v, (uint32_t)q);
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = x[i];
  } else {
    for (int s = 0; s < log_n; ++s) {
      const int lt = s;  // t = 2^s, h = n / 2t groups
      const int h = half >> s;
      for (int k = threadIdx.x; k < half; k += blockDim.x) {
        const int g = k >> lt;
        const int j = (g << (lt + 1)) + (k & ((1 << lt) - 1));
        const uint32_t u = x[j];
        const uint32_t v = x[j + (1 << lt)];
        x[j] = addmod(u, v, (uint32_t)q);
        x[j + (1 << lt)] = mulmod(submod(u, v, (uint32_t)q), psi[h + g], q, mu);
      }
      __syncthreads();
    }
    const uint32_t n_inv = (uint32_t)consts[3 * p + 2];
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[i] = mulmod(x[i], n_inv, q, mu);
  }
}

}  // namespace

extern "C" {

int ntt(const void* in, void* out, const void* table, const void* consts,
        long long rows, long long rows_per_prime, int n, int inverse,
        void* stream) {
  if (n < 2 || n > kMaxN || (n & (n - 1)) || rows_per_prime <= 0 ||
      rows % rows_per_prime || rows > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const int threads = n / 2 < kMaxThreads ? n / 2 : kMaxThreads;
  ntt_kernel<<<(unsigned)rows, threads, n * sizeof(uint32_t),
               (cudaStream_t)stream>>>(
      (const int64_t*)in, (int64_t*)out, (const int32_t*)table,
      (const int64_t*)consts, rows_per_prime, n, log_n, inverse);
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
