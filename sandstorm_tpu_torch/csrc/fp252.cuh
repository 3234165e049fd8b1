// Fp252 device arithmetic shared by every kernel of the port.
//
// An element is 8 little-endian u32 limbs of its Montgomery form (R = 2^256)
// for the Starkware prime p = 2^251 + 17*2^192 + 1.  In 32-bit limbs p is
// sparse: limb0 = 1, limb6 = 17, limb7 = 2^27, all others zero.  Because
// p == 1 (mod 2^32), -p^-1 == -1 (mod 2^32): the REDC multiplier of a round is
// m = -t_i, and adding m*p touches only three limbs.
//
// Replaces the digit-register tile helpers of sandstorm_tpu/fields/
// fp252_pallas.py (_montmul_tile, _field_add_tile, _field_sub_tile,
// _cond_sub_p_tile), which split an element into sixteen 16-bit digits
// because the TPU's vector unit has no widening multiply.  The H100 has a
// 32x32->64 integer multiply-add, so the limbs here are 32 bits wide.
#pragma once
#include <cstdint>

namespace fp {

struct F {
  uint32_t v[8];
};

// limb k of p (constant-folds under full unrolling)
static __device__ __forceinline__ uint32_t pw(int k) {
  return k == 0 ? 1u : (k == 6 ? 17u : (k == 7 ? (1u << 27) : 0u));
}

static __device__ __forceinline__ F load(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 x = q[0], y = q[1];
  F r;
  r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  r.v[4] = y.x; r.v[5] = y.y; r.v[6] = y.z; r.v[7] = y.w;
  return r;
}

static __device__ __forceinline__ void store(uint32_t* p, const F& a) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  q[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

static __device__ __forceinline__ F zero() {
  F r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = 0;
  return r;
}

// a < 2p  ->  a mod p
static __device__ __forceinline__ F cond_sub_p(const F& a) {
  F d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t s = (uint64_t)a.v[k] - pw(k) - borrow;
    d.v[k] = (uint32_t)s;
    borrow = s >> 63;  // operands < 2^33 in magnitude: the sign bit is the borrow
  }
  return borrow ? a : d;
}

static __device__ __forceinline__ F add(const F& a, const F& b) {
  F s;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t t = (uint64_t)a.v[k] + b.v[k] + c;
    s.v[k] = (uint32_t)t;
    c = t >> 32;
  }
  // a + b < 2p < 2^253: no carry leaves limb 7
  return cond_sub_p(s);
}

static __device__ __forceinline__ F sub(const F& a, const F& b) {
  F d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t t = (uint64_t)a.v[k] - b.v[k] - borrow;
    d.v[k] = (uint32_t)t;
    borrow = t >> 63;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      uint64_t t = (uint64_t)d.v[k] + pw(k) + c;
      d.v[k] = (uint32_t)t;
      c = t >> 32;
    }
  }
  return d;
}

// a * b * 2^-256 mod p for a, b < p: schoolbook product into 16 limbs, then
// eight sparse REDC rounds.  (T + M*p) / 2^256 < 2p, so one conditional
// subtract finishes.
static __device__ __forceinline__ F mul(const F& a, const F& b) {
  uint32_t t[17];
#pragma unroll
  for (int i = 0; i < 17; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      // (2^32-1)^2 + 2*(2^32-1) = 2^64-1: never overflows
      uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + 8] = (uint32_t)c;
  }
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t m = 0u - t[i];
    // t_i + m is 2^32 when t_i != 0 and 0 otherwise
    uint64_t c = t[i] != 0;
#pragma unroll
    for (int k = i + 1; k < 17; k++) {
      uint64_t s = (uint64_t)t[k] + c;
      if (k == i + 6) s += (uint64_t)m * 17u;
      if (k == i + 7) s += (uint64_t)m << 27;
      t[k] = (uint32_t)s;
      c = s >> 32;
    }
  }
  F r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = t[8 + k];
  return cond_sub_p(r);
}

}  // namespace fp
