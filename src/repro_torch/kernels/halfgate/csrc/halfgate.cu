// Half-Gate garbling and evaluation of independent AND gates, on the H100.
//
// Replaces the JAX package's Pallas kernels
//   kernels/halfgate/halfgate.py:64  garble_pallas (body _garble_kernel)
//   kernels/halfgate/halfgate.py:95  eval_pallas   (body _eval_kernel)
// with the same operands in the same layout: labels and table rows (G, 4)
// of 32-bit words, a per-gate FreeXOR offset r (G, 4) on the garbling side
// (batched instances carry their own R), tweaks (G,). The cipher is the
// shared kernels/csrc/halfgate.cuh, as in the level kernels.
//
// What bounds it on the H100: per gate, garbling moves 100 bytes (a0, b0,
// r and the tweak read; c0, tg, te written) against 518 32-bit integer
// operations (4 hashes of 115 and 58 of Half-Gate algebra), evaluation 84
// bytes (a, b, tg, te and the tweak read; c written) against 260 (2
// hashes and 30). At 3.35 TB/s and 132 SMs x 64 int32 lanes x 1.98 GHz
// (16.7 Tops/s), garbling is bound by operations and evaluation by bytes.
// One gate per thread, one 16-byte load per label, every hash in
// registers, a grid-stride loop so any G runs in one launch.
//
// The C entry points return cudaGetLastError() after the launch; the
// Python wrappers raise on anything but cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

#include "halfgate.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

long long grid_for(long long g) {
  long long b = (g + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

__global__ void garble_and_kernel(const uint4* __restrict__ a0,
                                  const uint4* __restrict__ b0,
                                  const uint4* __restrict__ r,
                                  const uint32_t* __restrict__ tweaks,
                                  uint4* __restrict__ c0_out,
                                  uint4* __restrict__ tg_out,
                                  uint4* __restrict__ te_out, long long g) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < g;
       i += stride) {
    uint4 c0, tg, te;
    halfgate::garble_and(a0[i], b0[i], r[i], tweaks[i], c0, tg, te);
    c0_out[i] = c0;
    tg_out[i] = tg;
    te_out[i] = te;
  }
}

__global__ void eval_and_kernel(const uint4* __restrict__ a,
                                const uint4* __restrict__ b,
                                const uint4* __restrict__ tg,
                                const uint4* __restrict__ te,
                                const uint32_t* __restrict__ tweaks,
                                uint4* __restrict__ out, long long g) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < g;
       i += stride)
    out[i] = halfgate::eval_and(a[i], b[i], tg[i], te[i], tweaks[i]);
}

}  // namespace

extern "C" {

int garble_and(const void* a0, const void* b0, const void* r,
               const void* tweaks, void* c0, void* tg, void* te, long long g,
               void* stream) {
  if (g < 0) return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  garble_and_kernel<<<(unsigned)grid_for(g), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint4*)a0, (const uint4*)b0, (const uint4*)r,
      (const uint32_t*)tweaks, (uint4*)c0, (uint4*)tg, (uint4*)te, g);
  return (int)cudaGetLastError();
}

int eval_and(const void* a, const void* b, const void* tg, const void* te,
             const void* tweaks, void* out, long long g, void* stream) {
  if (g < 0) return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  eval_and_kernel<<<(unsigned)grid_for(g), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const uint4*)a, (const uint4*)b, (const uint4*)tg, (const uint4*)te,
      (const uint32_t*)tweaks, (uint4*)out, g);
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
