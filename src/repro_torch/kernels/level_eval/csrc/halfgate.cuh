// Half-Gate cipher on the device: the ARX Davies–Meyer label hash.
//
// Bit for bit the function of the JAX package's kernels/halfgate/ref.py
// (and of repro_torch/kernels/halfgate/ref.py): H(x, t) = P(x ^ T(t)) ^
// (x ^ T(t)), with P an 8-round SipRound-style permutation of four 32-bit
// words and T(t) = (t, t ^ 0x9E3779B9, ~t, t + 0x85EBCA6B). Everything
// stays in registers; the rotations compile to funnel shifts.
//
// Cost per hash, counted in 32-bit integer operations: 8 rounds x 13
// (5 adds, 4 rotations, 4 XORs) = 104, 7 to expand and apply the tweak and
// 4 for the feed-forward XOR — 115.
#pragma once

#include <stdint.h>

namespace halfgate {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void arx_round(uint32_t& v0, uint32_t& v1,
                                          uint32_t& v2, uint32_t& v3,
                                          uint32_t rc) {
  v0 = v0 + v1 + rc;
  v1 = rotl(v1, 13) ^ v0;
  v2 = v2 + v3;
  v3 = rotl(v3, 16) ^ v2;
  v0 = v0 + v3;
  v3 = rotl(v3, 21) ^ v0;
  v2 = v2 + v1;
  v1 = rotl(v1, 17) ^ v2;
}

// H(x, t) for one 128-bit label x and a 32-bit tweak t.
__device__ __forceinline__ uint4 hash_labels(uint4 x, uint32_t t) {
  const uint4 in = make_uint4(x.x ^ t, x.y ^ (t ^ 0x9E3779B9u), x.z ^ ~t,
                              x.w ^ (t + 0x85EBCA6Bu));
  uint32_t v0 = in.x, v1 = in.y, v2 = in.z, v3 = in.w;
  arx_round(v0, v1, v2, v3, 0x9E3779B9u);
  arx_round(v0, v1, v2, v3, 0x85EBCA6Bu);
  arx_round(v0, v1, v2, v3, 0xC2B2AE35u);
  arx_round(v0, v1, v2, v3, 0x27D4EB2Fu);
  arx_round(v0, v1, v2, v3, 0x165667B1u);
  arx_round(v0, v1, v2, v3, 0xD3A2646Cu);
  arx_round(v0, v1, v2, v3, 0xFD7046C5u);
  arx_round(v0, v1, v2, v3, 0xB55A4F09u);
  return make_uint4(v0 ^ in.x, v1 ^ in.y, v2 ^ in.z, v3 ^ in.w);
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__device__ __forceinline__ uint4 and4(uint4 a, uint32_t m) {
  return make_uint4(a.x & m, a.y & m, a.z & m, a.w & m);
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

// 0x00000000 or 0xFFFFFFFF from a label's colour bit.
__device__ __forceinline__ uint32_t lsb_mask(uint4 x) { return 0u - (x.x & 1u); }

// Half-Gate evaluation of one AND gate: 2 hashes.
__device__ __forceinline__ uint4 eval_and(uint4 a, uint4 b, uint4 tg,
                                          uint4 te, uint32_t tweak) {
  const uint32_t t1 = tweak * 2u;
  const uint4 ha = hash_labels(a, t1);
  const uint4 hb = hash_labels(b, t1 + 1u);
  const uint4 wg = xor4(ha, and4(tg, lsb_mask(a)));
  const uint4 we = xor4(hb, and4(xor4(te, a), lsb_mask(b)));
  return xor4(wg, we);
}

// Half-Gate garbling of one AND gate: 4 hashes; writes c0, tg, te.
__device__ __forceinline__ void garble_and(uint4 a0, uint4 b0, uint4 r,
                                           uint32_t tweak, uint4& c0,
                                           uint4& tg, uint4& te) {
  const uint32_t t1 = tweak * 2u;
  const uint32_t t2 = t1 + 1u;
  const uint4 ha0 = hash_labels(a0, t1);
  const uint4 ha1 = hash_labels(xor4(a0, r), t1);
  const uint4 hb0 = hash_labels(b0, t2);
  const uint4 hb1 = hash_labels(xor4(b0, r), t2);
  const uint32_t pa = lsb_mask(a0);
  const uint32_t pb = lsb_mask(b0);
  tg = xor4(xor4(ha0, ha1), and4(r, pb));
  te = xor4(xor4(hb0, hb1), a0);
  const uint4 wg = xor4(ha0, and4(tg, pa));
  const uint4 we = xor4(hb0, and4(xor4(te, a0), pb));
  c0 = xor4(wg, we);
}

}  // namespace halfgate
