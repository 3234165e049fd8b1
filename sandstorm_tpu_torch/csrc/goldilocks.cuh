// Goldilocks device arithmetic, p = 2^64 - 2^32 + 1, shared by the
// Goldilocks kernels of the port.
//
// An element is its canonical value (< p) held as one u64, stored in memory
// as two little-endian u32 words (lo, hi): the [..., 2] int32 tensors of
// fields/goldilocks.py.  Not a Montgomery form.
//
// Replaces the tile ops of sandstorm_tpu/fields/gl_pallas.py (gl_mul_tile
// :29, gl_add_tile :40, gl_sub_tile :47) and the XLA GL.add/sub/mul of
// sandstorm_tpu/fields/goldilocks.py, which build every 64-bit step from
// u32 halves and a 16x16-bit multiply because the TPU's vector unit has no
// wider integer datapath.  The H100 has 64-bit integer adds and
// __umul64hi, so an element is one register pair here.  The reduction is
// step for step the one of gl_mul_tile / GL.reduce128, with 2^64 = 2^32 - 1
// and 2^96 = -1 (mod p): subtract the top word, fold the borrow, add the
// third word times 2^32 - 1, fold the carry, one conditional subtract of p.
#pragma once
#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

// element i of a [.., 2] u32 array (8-byte aligned)
static __device__ __forceinline__ uint64_t load(const uint32_t* p) {
  return *reinterpret_cast<const uint64_t*>(p);
}

static __device__ __forceinline__ void store(uint32_t* p, uint64_t a) {
  *reinterpret_cast<uint64_t*>(p) = a;
}

// a < 2p (as an integer below 2^64) -> a mod p
static __device__ __forceinline__ uint64_t cond_sub_p(uint64_t a) {
  return a >= P ? a - P : a;
}

static __device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;  // carry out: 2^64 = 2^32 - 1; cannot carry again
  return cond_sub_p(s);
}

static __device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= EPS;  // borrow: -2^64 = -(2^32 - 1); lands in [0, p)
  return d;
}

static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t w2 = hi & 0xFFFFFFFFull, w3 = hi >> 32;
  uint64_t t = lo - w3;              // w3 * 2^96 = -w3 (mod p)
  if (lo < w3) t -= EPS;             // fold the borrow
  const uint64_t t1 = w2 * EPS;      // w2 * 2^64 = w2 * (2^32 - 1), < 2^64
  uint64_t r = t + t1;
  if (r < t) r += EPS;               // fold the carry
  return cond_sub_p(r);
}

}  // namespace gl
