// Garbling and evaluation of one padded netlist level, on the H100.
//
// Replaces the JAX package's Pallas kernels
//   kernels/level_eval/level_eval.py:59  eval_level_pallas   (body _kernel)
//   kernels/level_eval/level_eval.py:83  garble_level_pallas (body _garble_kernel)
// with the same operands in the same (G, 4) layout: ops (G,), labels and
// table rows (G, 4) of 32-bit words, tweaks (G,). Per lane, by op
// (0 XOR, 1 AND, 2 INV, >= 3 PAD):
//   eval:   a ^ b | Half-Gate eval | a | 0
//   garble: c0 = a0 ^ b0 | Half-Gate garble | a0 ^ r | 0, and the two table
//           rows (tg, te), zero off the AND lanes.
//
// What bounds it on the H100: per lane, eval moves 88 B (the op and tweak
// words and 4 labels read, one label written) against about 280 32-bit
// integer operations (2 hashes of 115 plus the Half-Gate algebra and the
// select), and garble moves 104 B (2 words and 3 labels read, 3 labels
// written) against about 550 (4 hashes). At 3.35 TB/s and 132 SMs x 64
// int32 lanes x 1.98 GHz (16.7 Tops/s) eval is bound by bytes and garble
// by operations, each within a factor of two of the other limit. The
// design keeps every lane in one thread: one 16-byte load per
// label operand, both (or all four) hashes in registers, the op select as
// predicated moves with no branch, and a grid-stride loop so any G runs
// in one launch on a grid sized to the card.
//
// The C entry points return cudaGetLastError() after the launch; the
// Python wrappers raise on anything but cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

#include "halfgate.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 16 resident-block waves of 132 SMs

long long grid_for(long long g) {
  long long b = (g + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

__global__ void eval_level_kernel(const uint32_t* __restrict__ ops,
                                  const uint4* __restrict__ a,
                                  const uint4* __restrict__ b,
                                  const uint4* __restrict__ tg,
                                  const uint4* __restrict__ te,
                                  const uint32_t* __restrict__ tweaks,
                                  uint4* __restrict__ out, long long g) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < g;
       i += stride) {
    const uint32_t op = ops[i];
    const uint4 av = a[i];
    const uint4 bv = b[i];
    const uint4 c_and = halfgate::eval_and(av, bv, tg[i], te[i], tweaks[i]);
    uint4 c = halfgate::xor4(av, bv);
    c = (op == 1u) ? c_and : c;
    c = (op == 2u) ? av : c;
    c = (op >= 3u) ? make_uint4(0u, 0u, 0u, 0u) : c;
    out[i] = c;
  }
}

__global__ void garble_level_kernel(const uint32_t* __restrict__ ops,
                                    const uint4* __restrict__ a0,
                                    const uint4* __restrict__ b0,
                                    const uint4* __restrict__ r,
                                    const uint32_t* __restrict__ tweaks,
                                    uint4* __restrict__ c0_out,
                                    uint4* __restrict__ tg_out,
                                    uint4* __restrict__ te_out, long long g) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < g;
       i += stride) {
    const uint32_t op = ops[i];
    const uint4 av = a0[i];
    const uint4 bv = b0[i];
    const uint4 rv = r[i];
    uint4 c_and, tg, te;
    halfgate::garble_and(av, bv, rv, tweaks[i], c_and, tg, te);
    const bool is_and = op == 1u;
    uint4 c = halfgate::xor4(av, bv);
    c = is_and ? c_and : c;
    c = (op == 2u) ? halfgate::xor4(av, rv) : c;
    c = (op >= 3u) ? zero : c;
    c0_out[i] = c;
    tg_out[i] = is_and ? tg : zero;
    te_out[i] = is_and ? te : zero;
  }
}

}  // namespace

extern "C" {

int eval_level(const void* ops, const void* a, const void* b, const void* tg,
               const void* te, const void* tweaks, void* out, long long g,
               void* stream) {
  if (g <= 0) return 0;
  eval_level_kernel<<<(unsigned)grid_for(g), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)ops, (const uint4*)a, (const uint4*)b,
      (const uint4*)tg, (const uint4*)te, (const uint32_t*)tweaks,
      (uint4*)out, g);
  return (int)cudaGetLastError();
}

int garble_level(const void* ops, const void* a0, const void* b0,
                 const void* r, const void* tweaks, void* c0, void* tg,
                 void* te, long long g, void* stream) {
  if (g <= 0) return 0;
  garble_level_kernel<<<(unsigned)grid_for(g), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)ops, (const uint4*)a0, (const uint4*)b0,
      (const uint4*)r, (const uint32_t*)tweaks, (uint4*)c0, (uint4*)tg,
      (uint4*)te, g);
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
