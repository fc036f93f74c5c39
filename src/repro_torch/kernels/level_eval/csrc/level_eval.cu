// Garbling and evaluation of netlist levels, on the H100.
//
// Replaces the JAX package's Pallas kernels
//   kernels/level_eval/level_eval.py:59  eval_level_pallas   (body _kernel)
//   kernels/level_eval/level_eval.py:83  garble_level_pallas (body _garble_kernel)
// twice: eval_level_kernel / garble_level_kernel are their one-to-one
// counterparts (one level per launch); eval_walk / garble_walk, below,
// are their redesign for the serving path (one launch per level plan).
//
// eval_level / garble_level take the Pallas kernels' operands in the same
// (G, 4) layout: ops (G,), labels and
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "halfgate.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// Whole walks: one launch per level plan.
//
// eval_walk_kernel / garble_walk_kernel run every chunk of a compiled level
// plan (core/netlist.py::compile_level_plan) over the row-major wire store
// (rows, I, 4), reading one packed int32 record per chunk
// (kernels/level_eval/ref.py::WalkMeta; the plain walks in ref.py read the
// same records): gather rows [a | b | fa | fb], commit rows, tweak, op and,
// on evaluate, the table slot per AND lane, or, on garble, table_base.
//
// What bounds a walk. Its work is the level kernels' summed over chunks
// (per real AND gate and instance: eval 2 hashes, about 280 int32
// operations; garble 4, about 550), and its bytes are the source labels,
// the tables and the output labels, each moved once; both are small at
// the serving shapes (softmax8 at I = 8: 44,415 ANDs x 8 x 279 operations
// is about 6 us of the card). But chunk k + 1 reads what chunk k wrote, so
// a walk is a chain of n_chunks dependent steps (2,601 for softmax8), each
// at least a gather's latency, a hash chain and two barriers: at small I
// the chain, not the roofline, sets the time. The design answers with one
// launch per walk (no host round trip per chunk), and keeps each step
// short:
//
// * Ownership of instances. Instances are independent circuits: instance i
//   reads and writes only column i of the store. The grid is cut by
//   instance tile; the blocks of a tile (one block, or a cluster of up to
//   8 where the tiles leave SMs idle: softmax8 and the LayerNorm at I = 8,
//   the LayerNorm at I = 32) walk every chunk in order, and no other block
//   touches the tile's columns, so no barrier spans the grid. Items are
//   (lane, instance) pairs with the instance fastest: a row's gather is a
//   run of 16-byte loads over contiguous columns. The cluster splits each
//   chunk's AND items and free items evenly over its blocks, so every
//   block shares the hashing.
// * Per chunk: gather and compute into shared memory (AND lanes run the
//   Half-Gate in registers; free lanes XOR), barrier, commit, barrier.
//   Read before write: the pad-lane tail of a chunk's commit block may
//   clobber a row that the same chunk reads (core/netlist.py: dead rows are
//   recycled), so no thread commits before every thread of the tile has
//   gathered. Visibility: the commits of chunk k must be seen by the
//   gathers of chunk k + 1 in other blocks of the cluster; __syncthreads
//   orders one block only, so a cluster uses barrier.cluster (arrive
//   .release / wait.acquire: cluster scope, global memory included), and
//   every store read is ld.global.cg (L2, never a stale L1 line).
// * Table spill (garble): a chunk's pad AND lanes write zero table rows
//   into rows that later chunks own; the chunk barriers order them before
//   those chunks' writes, as the plain walk's sequence does.
// * Pad slots (evaluate) read a clamped real table slot and output zero;
//   PAD lanes skip the hash.
// * Metadata: while it computes chunk k, a block brings chunk k + 1's record
//   into the other half of a double buffer in shared memory with cp.async
//   (16-byte copies; records are padded to 16 bytes). The LayerNorm's
//   record is 72 KB, so its two buffers and its staged outputs take 224 KB
//   of dynamic shared memory (cudaFuncSetAttribute).
// * 64-bit offsets: row * I + i is computed in 64 bits (the LayerNorm
//   garble store at I = 32 is 1.17 GB).
// * Walks of very different shape (I from 1 to 73,728, chunks of 16 to
//   5,120 lanes): the wrapper (level_eval.py::walk_shape) chooses the tile
//   and cluster size from (and_width, free_width, I) and sizes the shared
//   memory; the kernel loops over any item count.

constexpr int kWalkThreads = 256;  // WALK_THREADS in level_eval.py

struct WalkParams {
  const int4* records;  // (n_chunks, stride) int32, stride % 4 == 0
  long long n_chunks;
  int stride, ca, cf;
  uint4* store;  // (rows, I, 4)
  long long instances;
  int tile, cluster, per_and, per_free;
  // evaluate: (table_rows, I, 4) table halves; garble: r (I, 4) and the
  // (table_rows, I, 4) table stores written
  const uint4* tg_in;
  const uint4* te_in;
  const uint4* r;
  uint4* tg_out;
  uint4* te_out;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Every thread of the tile: the block alone, or the whole cluster with
// release/acquire at cluster scope.
__device__ __forceinline__ void tile_sync(int cluster) {
  if (cluster > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <bool kGarble>
__global__ void __launch_bounds__(kWalkThreads)
    walk_kernel(const WalkParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* stage = reinterpret_cast<uint4*>(smem);
  int* rec_buf = reinterpret_cast<int*>(stage + p.per_and + p.per_free);

  const int rank = (int)(blockIdx.x % (unsigned)p.cluster);
  const long long i0 = (long long)(blockIdx.x / (unsigned)p.cluster) * p.tile;
  const long long left = p.instances - i0;
  const int ti = left < p.tile ? (int)left : p.tile;  // ragged last tile
  const int a_lo = rank * p.per_and;
  const int a_hi = min(p.ca * ti, a_lo + p.per_and);
  const int f_lo = rank * p.per_free;
  const int f_hi = min(p.cf * ti, f_lo + p.per_free);
  const long long I = p.instances;
  const int ca = p.ca, cf = p.cf;
  // record fields (ref.py::walk_offsets)
  const int o_dest = 2 * ca + 2 * cf, o_tweak = 3 * ca + 3 * cf,
            o_op = 4 * ca + 3 * cf, o_extra = 5 * ca + 3 * cf;
  const int words4 = p.stride / 4;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  auto fetch = [&](long long k, int buf) {
    const int4* src = p.records + k * words4;
    int4* dst = reinterpret_cast<int4*>(rec_buf + buf * p.stride);
    for (int j = threadIdx.x; j < words4; j += kWalkThreads) {
      cp_async16(dst + j, src + j);
    }
    cp_async_commit();
  };

  fetch(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (long long k = 0; k < p.n_chunks; ++k) {
    const int* rec = rec_buf + (int)(k & 1) * p.stride;
    if (k + 1 < p.n_chunks) fetch(k + 1, (int)((k + 1) & 1));

    // gather and compute: AND items, then free items
    for (int w = a_lo + threadIdx.x; w < a_hi; w += kWalkThreads) {
      const int l = w / ti;
      const long long i = i0 + w % ti;
      const uint4 a = __ldcg(p.store + (long long)rec[l] * I + i);
      const uint4 b = __ldcg(p.store + (long long)rec[ca + l] * I + i);
      const uint32_t tweak = (uint32_t)rec[o_tweak + l];
      const bool is_and = rec[o_op + l] == 1;
      uint4 c = zero;
      if constexpr (kGarble) {
        uint4 tg = zero, te = zero;
        if (is_and) halfgate::garble_and(a, b, p.r[i], tweak, c, tg, te);
        const long long t = (long long)(rec[o_extra] + l) * I + i;
        p.tg_out[t] = tg;
        p.te_out[t] = te;
      } else {
        if (is_and) {
          const long long t = (long long)rec[o_extra + l] * I + i;
          c = halfgate::eval_and(a, b, p.tg_in[t], p.te_in[t], tweak);
        }
      }
      stage[w - a_lo] = c;
    }
    for (int w = f_lo + threadIdx.x; w < f_hi; w += kWalkThreads) {
      const int l = w / ti;
      const long long i = i0 + w % ti;
      const uint4 fa = __ldcg(p.store + (long long)rec[2 * ca + l] * I + i);
      const uint4 fb =
          __ldcg(p.store + (long long)rec[2 * ca + cf + l] * I + i);
      stage[p.per_and + w - f_lo] = halfgate::xor4(fa, fb);
    }
    tile_sync(p.cluster);  // every gather of chunk k before any commit

    for (int w = a_lo + threadIdx.x; w < a_hi; w += kWalkThreads) {
      const int l = w / ti;
      p.store[(long long)rec[o_dest + l] * I + i0 + w % ti] = stage[w - a_lo];
    }
    for (int w = f_lo + threadIdx.x; w < f_hi; w += kWalkThreads) {
      const int l = w / ti;
      p.store[(long long)rec[o_dest + ca + l] * I + i0 + w % ti] =
          stage[p.per_and + w - f_lo];
    }
    cp_async_wait_all();  // chunk k + 1's record, this thread's copies
    tile_sync(p.cluster);  // commits (and record copies) seen by all
  }
}

template <bool kGarble>
int launch_walk(const void* records, long long n_chunks, int stride, int ca,
                int cf, void* store, long long instances, int tile,
                int cluster, int per_and, int per_free, int smem,
                const void* tg_in, const void* te_in, const void* r,
                void* tg_out, void* te_out, void* stream) {
  if (n_chunks <= 0 || instances <= 0) return 0;
  if (stride % 4 || tile <= 0 || cluster <= 0 || cluster > 8) {
    return (int)cudaErrorInvalidValue;
  }
  WalkParams p;
  p.records = (const int4*)records;
  p.n_chunks = n_chunks;
  p.stride = stride;
  p.ca = ca;
  p.cf = cf;
  p.store = (uint4*)store;
  p.instances = instances;
  p.tile = tile;
  p.cluster = cluster;
  p.per_and = per_and;
  p.per_free = per_free;
  p.tg_in = (const uint4*)tg_in;
  p.te_in = (const uint4*)te_in;
  p.r = (const uint4*)r;
  p.tg_out = (uint4*)tg_out;
  p.te_out = (uint4*)te_out;
  cudaError_t e = cudaFuncSetAttribute(
      walk_kernel<kGarble>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (instances + tile - 1) / tile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * cluster), 1, 1);
  cfg.blockDim = dim3(kWalkThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, walk_kernel<kGarble>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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

int eval_walk(const void* records, long long n_chunks, int stride, int ca,
              int cf, void* store, long long instances, int tile,
              int cluster, int per_and, int per_free, int smem,
              const void* tg_rows, const void* te_rows, void* stream) {
  return launch_walk<false>(records, n_chunks, stride, ca, cf, store,
                            instances, tile, cluster, per_and, per_free, smem,
                            tg_rows, te_rows, nullptr, nullptr, nullptr,
                            stream);
}

int garble_walk(const void* records, long long n_chunks, int stride, int ca,
                int cf, void* store, long long instances, int tile,
                int cluster, int per_and, int per_free, int smem,
                const void* r, void* tg_store, void* te_store,
                void* stream) {
  return launch_walk<true>(records, n_chunks, stride, ca, cf, store,
                           instances, tile, cluster, per_and, per_free, smem,
                           nullptr, nullptr, r, tg_store, te_store, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
