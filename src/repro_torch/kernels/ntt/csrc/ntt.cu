// Negacyclic NTT and inverse NTT over Z_q[X]/(X^N+1), on the H100.
//
// Replaces the JAX package's Pallas kernel
//   kernels/ntt/ntt.py:89  ntt_pallas  (bodies _fwd_kernel, _inv_kernel)
// with the same transform (Longa–Naehrig butterflies, merged bit-reversed
// psi tables, the inverse ending with the n^-1 scale), for any prime
// q < 2^31 rather than the TPU kernel's int32 limb primes (q <= 46340).
// Residues are int64 in [0, q) in device memory and uint32 in registers.
//
// Layout: `rows` polynomials of length n, row-major; the first
// rows_per_prime rows are taken mod primes[0], the next mod primes[1], and
// so on, so one launch covers every RNS limb of a batch. The tables are
// (P, n) pairs {w, w'} of psi (or inverse psi) powers and their Shoup
// companions w' = floor(w * 2^32 / q); the constants are (P, 8) uint32:
// q, n^-1, its companion, psi^-1[1] * n^-1 and its companion.
//
// What bounds it: device memory. A transform moves 16 B per coefficient
// (an int64 read and an int64 write); at n = 2048 its butterflies cost
// 11 * 11 / 2 = 60.5 int32 instructions per coefficient, so the bytes
// (3.35 TB/s) take longer than the instructions (16.7 Tops/s) as long as
// the instructions stay that few and the loads and stores stay wide.
// What the design does about it:
//
// 1. 32-bit Shoup products. a * w mod q is __umulhi(a, w'), two 32-bit
//    multiplies and one conditional subtract (a min of two uint32s): exact
//    for every a < 2^32 and w < q < 2^31, since a*w - floor(a*w'/2^32)*q
//    lies in [0, 2q) and 2q < 2^32. A modular add or subtract is one add
//    and one min. Every value stays fully reduced, so one instantiation is
//    exact for every prime the wrapper takes (Harvey's lazy [0, 4q) form
//    would overflow uint32 for q >= 2^30).
// 2. Stages merged in registers. Each thread holds R = 16 coefficients of
//    a row (R = n below n = 16) and runs up to log2 R stages on them
//    between shared-memory exchanges. Rounds of a row of n = 2^L:
//      io    — the coefficients a thread loads and stores: register k
//              holds index (k & 1) | (t << 1) | ((k >> 1) << (L - r + 1)),
//              r = log2 R, so it runs the r - 1 highest stages (forward)
//              or the lowest (inverse) and, at the end, stage 0 (forward)
//              or the r - 1 highest (inverse);
//      mid b — register k holds index bits [b, b + r) of its coefficient,
//              the thread the other bits; runs the stages of index bits
//              [1, L - r] in chunks of up to r.
//    At n = 2048 that is 3 exchanges and 3 __syncthreads() instead of 11.
//    Exchanges alternate between two buffers, so each needs one barrier.
//    The length is a template parameter (one instantiation per n and
//    direction), so the rounds, the layouts' bases, the exchanges' word
//    offsets and the twiddles' offsets are compile-time constants.
//    A word at block address a is stored at a ^ g(a >> 5), g(h) = (h ^
//    h >> 1 ^ h >> 2 ^ h << 1) & 31, a GF(2)-linear swizzle under which
//    every warp's 32 accesses of every exchange fall in 32 distinct banks
//    for n >= 512 (2-way at n = 256). Being linear, it is applied once to
//    a thread's part of the address; each register's word is that XOR a
//    constant.
//    Twiddles {w, w'} are read as one 8-byte __ldg per butterfly, at
//    indices that depend only on the round, the thread and the register,
//    never on data: the loads issue ahead of the butterflies. The first
//    forward round's (and last inverse round's) twiddles are the same for
//    every thread.
// 3. Vector I/O. A row is loaded and stored as longlong2 (two int64), the
//    threads of a row on consecutive 16-byte words, and narrowed to 32
//    bits in registers.
// 4. The inverse's n^-1 scale is folded into its last stage (t = n/2, one
//    twiddle): u' = (u + v) * n^-1 and v' = (u - v) * (psi^-1[1] * n^-1),
//    two Shoup products with host-built constants; no separate pass.
// 5. Grid. Blocks of 128 threads (one row at n = 2048, 128 / (n / 16)
//    rows below; 256 or 512 threads for one row at n = 4096, 8192), at
//    most 56 registers so that 9 blocks fit an SM: the 3 x 384 rows of a
//    768-wide HE product run in one wave of 1,188 resident blocks. Larger
//    batches loop: the grid is the resident block count and each block
//    walks rows grid-stride.
//
// The C entry point returns cudaErrorInvalidValue for a length it does not
// take, otherwise cudaGetLastError() after the launch; the Python wrapper
// raises on anything but cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLogN = 13;   // n = 8192
constexpr int kLogR = 4;       // 16 coefficients per thread
constexpr int kBlock = 128;    // threads per block up to n = 2048
constexpr int kConsts = 8;     // uint32 constants per prime

// a * w mod q for a < 2^32, w < q < 2^31, wp = floor(w * 2^32 / q)
__device__ __forceinline__ uint32_t shoup(uint32_t a, uint32_t w, uint32_t wp,
                                          uint32_t q) {
  const uint32_t r = a * w - __umulhi(a, wp) * q;  // in [0, 2q)
  return min(r, r - q);
}

__device__ __forceinline__ uint32_t addmod(uint32_t u, uint32_t v, uint32_t q) {
  const uint32_t s = u + v;  // < 2q < 2^32
  return min(s, s - q);
}

__device__ __forceinline__ uint32_t submod(uint32_t u, uint32_t v, uint32_t q) {
  const uint32_t d = u - v;  // wraps above 2^31 when u < v
  return min(d, d + q);
}

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// shared-memory word of block address a (linear over XOR)
__host__ __device__ constexpr uint32_t swz(uint32_t a) {
  return a ^ (((a >> 5) ^ (a >> 6) ^ (a >> 7) ^ ((a >> 5) << 1)) & 31u);
}

// Everything about a launch at n = 2^LOG_N, fixed at compile time.
template <int LOG_N>
struct Shape {
  static constexpr int LOG_R = cmin(LOG_N, kLogR);
  static constexpr int R = 1 << LOG_R;                   // registers
  static constexpr int LT = LOG_N - LOG_R;               // log2 threads/row
  static constexpr int BLOCK = cmax(1 << LT, kBlock);
  static constexpr int RPB = BLOCK >> LT;                // rows per block
  static constexpr uint32_t WORDS = (uint32_t)RPB << LOG_N;  // one buffer
  static constexpr int CHUNKS = (LT + LOG_R - 1) / LOG_R;     // mid rounds
  static constexpr int MIN_BLOCKS = BLOCK == kBlock ? 9 : 1024 / BLOCK;
  // mid round c covers index bits [lo, hi] with registers based at `base`
  // (forward from the top of [1, LT] down, inverse from the bottom up)
  __host__ __device__ static constexpr int lo(int c, bool inv) {
    return inv ? 1 + c * LOG_R : cmax(1, LT - c * LOG_R - LOG_R + 1);
  }
  __host__ __device__ static constexpr int hi(int c, bool inv) {
    return inv ? cmin(LT, c * LOG_R + LOG_R) : LT - c * LOG_R;
  }
  __host__ __device__ static constexpr int base(int c, bool inv) {
    return cmax(0, hi(c, inv) - LOG_R + 1);
  }
  // swizzled word of register k's index bits in a layout (-1: io)
  __host__ __device__ static constexpr uint32_t kword(int layout, int k) {
    uint32_t a = 0;
    for (int i = 0; i < LOG_R; ++i)
      if ((k >> i) & 1)
        a |= layout < 0 ? (i == 0 ? 1u : 1u << (LT + i)) : 1u << (layout + i);
    return swz(a);
  }
};

struct Prime {
  uint32_t q, ninv, ninv_p, last, last_p;
};

// One butterfly on the pair (k, k + 2^i) of registers.
template <bool INV>
__device__ __forceinline__ void butterfly(uint32_t& a, uint32_t& b, uint2 w,
                                          uint32_t q) {
  if (!INV) {  // Cooley–Tukey: (a + b w, a - b w)
    const uint32_t v = shoup(b, w.x, w.y, q);
    b = submod(a, v, q);
    a = addmod(a, v, q);
  } else {     // Gentleman–Sande: (a + b, (a - b) w)
    const uint32_t d = a + q - b;  // in (0, 2q)
    a = addmod(a, b, q);
    b = shoup(d, w.x, w.y, q);
  }
}

// The inverse's last stage with n^-1 folded in.
__device__ __forceinline__ void butterfly_scaled(uint32_t& a, uint32_t& b,
                                                 const Prime& pr) {
  const uint32_t s = a + b, d = a + pr.q - b;  // both below 2q
  a = shoup(s, pr.ninv, pr.ninv_p, pr.q);
  b = shoup(d, pr.last, pr.last_p, pr.q);
}

// Stages of register bits [I_LO, I_HI] in the io layout: register bit 0 is
// index bit 0, register bit i >= 1 index bit LT + i. Forward stages run
// from the highest bit down, inverse ones up. The pair whose lower index
// is j, at index bit b, takes twiddle m + (j >> (b + 1)), m = n >> (b + 1);
// `tw_t` is the table advanced by the thread's t.
template <int LOG_N, bool INV, int I_LO, int I_HI>
__device__ __forceinline__ void io_stages(uint32_t (&x)[Shape<LOG_N>::R],
                                          const uint2* tw, const uint2* tw_t,
                                          const Prime& pr) {
  using S = Shape<LOG_N>;
#pragma unroll
  for (int s = 0; s < S::LOG_R; ++s) {
    const int i = INV ? s : S::LOG_R - 1 - s;
    if (i < I_LO || i > I_HI) continue;
#pragma unroll
    for (int k = 0; k < S::R; ++k) {
      if (k & (1 << i)) continue;
      if (INV && i == S::LOG_R - 1) {  // index bit L - 1: the last stage
        butterfly_scaled(x[k], x[k | (1 << i)], pr);
        continue;
      }
      const uint2 w = i == 0
          ? __ldg(tw_t + (1 << (LOG_N - 1)) + ((k >> 1) << S::LT))
          : __ldg(tw + (1 << (S::LOG_R - 1 - i)) + (k >> (i + 1)));
      butterfly<INV>(x[k], x[k | (1 << i)], w, pr.q);
    }
  }
}

// Stages of register bits [I_LO, I_HI] in the layout mid BASE: register
// bit i is index bit BASE + i; the thread's low BASE bits are index bits
// below BASE, its other bits index bits from BASE + LOG_R up.
template <int LOG_N, bool INV, int BASE, int I_LO, int I_HI>
__device__ __forceinline__ void mid_stages(uint32_t (&x)[Shape<LOG_N>::R],
                                           const uint2* tw, int t, uint32_t q) {
  using S = Shape<LOG_N>;
  const int thigh = t >> BASE;
#pragma unroll
  for (int s = 0; s < S::LOG_R; ++s) {
    const int i = INV ? s : S::LOG_R - 1 - s;
    if (i < I_LO || i > I_HI) continue;
    const uint2* wb = tw + (1 << (LOG_N - 1 - BASE - i)) +
                      (thigh << (S::LOG_R - 1 - i));
#pragma unroll
    for (int k = 0; k < S::R; ++k) {
      if (k & (1 << i)) continue;
      butterfly<INV>(x[k], x[k | (1 << i)], __ldg(wb + (k >> (i + 1))), q);
    }
  }
}

// A thread's part of its block addresses in a layout (-1: io).
template <int LOG_N, int LAYOUT>
__device__ __forceinline__ uint32_t thread_word(int t, int rib) {
  using S = Shape<LOG_N>;
  const uint32_t row = (uint32_t)rib << LOG_N;
  if constexpr (LAYOUT < 0) return swz(row | (uint32_t)(t << 1));
  else return swz(row | (uint32_t)(t & ((1 << LAYOUT) - 1)) |
             ((uint32_t)(t >> LAYOUT) << (LAYOUT + S::LOG_R)));
}

// Registers from layout FROM to layout TO through the buffer at `off`
// (words): the swizzle is linear, so a register's word is the thread's
// word XOR a constant.
template <int LOG_N, int FROM, int TO>
__device__ __forceinline__ void exchange(uint32_t (&x)[Shape<LOG_N>::R],
                                         uint32_t* smem, uint32_t off, int t,
                                         int rib) {
  using S = Shape<LOG_N>;
  const uint32_t src = off | thread_word<LOG_N, FROM>(t, rib);
#pragma unroll
  for (int k = 0; k < S::R; ++k) smem[src ^ S::kword(FROM, k)] = x[k];
  __syncthreads();
  const uint32_t dst = off | thread_word<LOG_N, TO>(t, rib);
#pragma unroll
  for (int k = 0; k < S::R; ++k) x[k] = smem[dst ^ S::kword(TO, k)];
}

// Mid rounds C.. of a row; exchanges alternate between the two buffers
// (`off` is 0 or WORDS), so each needs one barrier.
template <int LOG_N, bool INV, int C>
__device__ __forceinline__ void mid_rounds(uint32_t (&x)[Shape<LOG_N>::R],
                                           uint32_t* smem, uint32_t& off,
                                           const uint2* tw, int t, int rib,
                                           uint32_t q) {
  using S = Shape<LOG_N>;
  if constexpr (C < S::CHUNKS) {
    constexpr int FROM = C == 0 ? -1 : S::base(C - 1, INV);
    constexpr int BASE = S::base(C, INV);
    exchange<LOG_N, FROM, BASE>(x, smem, off, t, rib);
    off ^= S::WORDS;
    mid_stages<LOG_N, INV, BASE, S::lo(C, INV) - BASE, S::hi(C, INV) - BASE>(
        x, tw, t, q);
    mid_rounds<LOG_N, INV, C + 1>(x, smem, off, tw, t, rib, q);
  } else {
    exchange<LOG_N, S::base(C - 1, INV), -1>(x, smem, off, t, rib);
    off ^= S::WORDS;
  }
}

template <int LOG_N, bool INV>
__global__ void __launch_bounds__(Shape<LOG_N>::BLOCK,
                                  Shape<LOG_N>::MIN_BLOCKS)
ntt_kernel(const longlong2* __restrict__ in, longlong2* __restrict__ out,
           const uint2* __restrict__ table, const uint32_t* __restrict__ consts,
           long long rows, long long rows_per_prime) {
  using S = Shape<LOG_N>;
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x & ((1 << S::LT) - 1);
  const int rib = threadIdx.x >> S::LT;  // row within the block
  const long long groups = (rows + S::RPB - 1) / S::RPB;
  uint32_t off = 0;

  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long row = g * S::RPB + rib;
    const bool valid = row < rows;
    const long long p = (valid ? row : rows - 1) / rows_per_prime;
    const uint32_t* c = consts + kConsts * p;
    const Prime pr{__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3),
                   __ldg(c + 4)};
    const uint2* tw = table + (p << LOG_N);
    // longlong2 c2 of the thread holds registers 2 c2 and 2 c2 + 1
    const longlong2* src = in + ((row << LOG_N) >> 1) + t;
    uint32_t x[S::R];
#pragma unroll
    for (int c2 = 0; c2 < S::R / 2; ++c2) {
      const longlong2 v = valid ? __ldg(src + (c2 << S::LT))
                                : make_longlong2(0, 0);
      x[2 * c2] = (uint32_t)v.x;
      x[2 * c2 + 1] = (uint32_t)v.y;
    }

    io_stages<LOG_N, INV, INV ? 0 : 1, INV ? 0 : S::LOG_R - 1>(x, tw, tw + t,
                                                                pr);
    if constexpr (S::LT > 0)
      mid_rounds<LOG_N, INV, 0>(x, smem, off, tw, t, rib, pr.q);
    io_stages<LOG_N, INV, INV ? 1 : 0, INV ? S::LOG_R - 1 : 0>(x, tw, tw + t,
                                                                pr);

    if (valid) {
      longlong2* dst = out + ((row << LOG_N) >> 1) + t;
#pragma unroll
      for (int c2 = 0; c2 < S::R / 2; ++c2)
        dst[c2 << S::LT] =
            make_longlong2((long long)x[2 * c2], (long long)x[2 * c2 + 1]);
    }
  }
}

int sm_count() {
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!sms[dev])
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 1;
}

template <int LOG_N, bool INV>
int launch(const void* in, void* out, const void* table, const void* consts,
           long long rows, long long rows_per_prime, cudaStream_t stream) {
  using S = Shape<LOG_N>;
  auto kernel = ntt_kernel<LOG_N, INV>;
  const size_t smem = S::LT > 0 ? 2 * sizeof(uint32_t) * S::WORDS : 0;
  static int resident;  // blocks per SM
  if (!resident) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, S::BLOCK, smem);
    if (e != cudaSuccess) return (int)e;
    resident = per_sm > 0 ? per_sm : 1;
  }
  const long long groups = (rows + S::RPB - 1) / S::RPB;
  const long long most = (long long)resident * sm_count();
  const unsigned grid = (unsigned)(groups < most ? groups : most);
  ntt_kernel<LOG_N, INV><<<grid, S::BLOCK, smem, stream>>>(
      (const longlong2*)in, (longlong2*)out, (const uint2*)table,
      (const uint32_t*)consts, rows, rows_per_prime);
  return (int)cudaGetLastError();
}

template <bool INV>
int dispatch(int log_n, const void* in, void* out, const void* table,
             const void* consts, long long rows, long long rows_per_prime,
             cudaStream_t s) {
#define NTT_CASE(L) \
  case L: return launch<L, INV>(in, out, table, consts, rows, rows_per_prime, s);
  switch (log_n) {
    NTT_CASE(1) NTT_CASE(2) NTT_CASE(3) NTT_CASE(4) NTT_CASE(5) NTT_CASE(6)
    NTT_CASE(7) NTT_CASE(8) NTT_CASE(9) NTT_CASE(10) NTT_CASE(11)
    NTT_CASE(12) NTT_CASE(13)
  }
#undef NTT_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int ntt(const void* in, void* out, const void* table, const void* consts,
        long long rows, long long rows_per_prime, int n, int inverse,
        void* stream) {
  if (n < 2 || n > (1 << kMaxLogN) || (n & (n - 1)) || rows_per_prime <= 0 ||
      rows % rows_per_prime || rows > 0x7FFFFFFFLL ||
      ((uintptr_t)in | (uintptr_t)out) % sizeof(longlong2))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  return inverse ? dispatch<true>(log_n, in, out, table, consts, rows,
                                  rows_per_prime, (cudaStream_t)stream)
                 : dispatch<false>(log_n, in, out, table, consts, rows,
                                   rows_per_prime, (cudaStream_t)stream);
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
