// Active-label encoding W = W0 ^ (bit ? R : 0), on the H100.
//
// Replaces the JAX package's Pallas kernel
//   kernels/label_select/label_select.py:37  select_labels_pallas (body _kernel)
// on the same (G, 4) label rows of 32-bit words and (G,) bits. Where the
// Pallas kernel reads a per-row R (the dispatch broadcasts it to (G, 4)),
// this one reads R from a (G / group, 4) table, row g / group: the
// protocol's R is one label per garbled instance, shared by the `group`
// input wires of that instance, so the broadcast copy is never made.
//
// What bounds it on the H100: per row 36 bytes (a label and a bit read,
// a label written; R's rows are few and stay in L2) against 9 32-bit
// integer operations: bound by bytes, at 3.35 TB/s, by a factor of about
// 20. One thread per row, one 16-byte load per label, a grid-stride loop
// so any G runs in one launch on a grid sized to the card.
//
// The C entry point returns cudaGetLastError() after the launch; the
// Python wrapper raises on anything but cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

__global__ void select_labels_kernel(const uint4* __restrict__ w0,
                                     const uint4* __restrict__ r,
                                     const uint32_t* __restrict__ bits,
                                     uint4* __restrict__ out, long long g,
                                     long long group) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < g;
       i += stride) {
    const uint32_t m = 0u - bits[i];
    const uint4 w = w0[i];
    const uint4 d = r[i / group];
    out[i] = make_uint4(w.x ^ (d.x & m), w.y ^ (d.y & m), w.z ^ (d.z & m),
                        w.w ^ (d.w & m));
  }
}

}  // namespace

extern "C" {

int select_labels(const void* w0, const void* r, const void* bits, void* out,
                  long long g, long long group, void* stream) {
  if (g < 0 || group <= 0) return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  long long blocks = (g + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  select_labels_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint4*)w0, (const uint4*)r, (const uint32_t*)bits, (uint4*)out,
      g, group);
  return (int)cudaGetLastError();
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
