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

static __device__ __forceinline__ uint64_t neg(uint64_t a) {
  return sub(0, a);
}

}  // namespace gl

// GF(p^3) = GF(p)[x] / (x^3 - 2): an element (c0, c1, c2) is c0 + c1 x +
// c2 x^2, three canonical coordinates, stored as 6 little-endian u32 words
// (the [..., 6] tensors of fields/gl3.py), 8-byte aligned.  The functions
// are those of the JAX package's GL3 (sandstorm_tpu/fields/gl3.py: add,
// sub, neg coordinatewise; mul :284, 9 base products and x^3 = 2), each
// result canonical, so any order of the same field operations gives the
// same words.
namespace gl3 {

struct E {
  uint64_t c0, c1, c2;
};

static __device__ __forceinline__ E load(const uint32_t* p) {
  return {gl::load(p), gl::load(p + 2), gl::load(p + 4)};
}

static __device__ __forceinline__ void store(uint32_t* p, const E& a) {
  gl::store(p, a.c0);
  gl::store(p + 2, a.c1);
  gl::store(p + 4, a.c2);
}

static __device__ __forceinline__ E zero() { return {0, 0, 0}; }
static __device__ __forceinline__ E one() { return {1, 0, 0}; }

static __device__ __forceinline__ E add(const E& a, const E& b) {
  return {gl::add(a.c0, b.c0), gl::add(a.c1, b.c1), gl::add(a.c2, b.c2)};
}

static __device__ __forceinline__ E sub(const E& a, const E& b) {
  return {gl::sub(a.c0, b.c0), gl::sub(a.c1, b.c1), gl::sub(a.c2, b.c2)};
}

static __device__ __forceinline__ E neg(const E& a) {
  return {gl::neg(a.c0), gl::neg(a.c1), gl::neg(a.c2)};
}

// the order of GL3.mul: d0..d4 of the schoolbook product, then x^3 = 2
// (d * 2 as d + d: the same canonical value as the multiply by 2)
static __device__ __forceinline__ E mul(const E& a, const E& b) {
  const uint64_t d0 = gl::mul(a.c0, b.c0);
  const uint64_t d1 = gl::add(gl::mul(a.c0, b.c1), gl::mul(a.c1, b.c0));
  const uint64_t d2 = gl::add(gl::add(gl::mul(a.c0, b.c2),
                                      gl::mul(a.c1, b.c1)),
                              gl::mul(a.c2, b.c0));
  const uint64_t d3 = gl::add(gl::mul(a.c1, b.c2), gl::mul(a.c2, b.c1));
  const uint64_t d4 = gl::mul(a.c2, b.c2);
  return {gl::add(d0, gl::add(d3, d3)), gl::add(d1, gl::add(d4, d4)), d2};
}

}  // namespace gl3

// The two fields behind one interface, for the kernels that take either
// (templates on the field: gl_scan.cu, gl_deep.cu, gl_open.cu, and the
// generated group kernels of air/codegen.py): the element and its words,
// zero and one, the field operations above, loads and stores, an L2 load
// (a value another block published in the same launch) and warp shuffles.
struct GLF {
  using E = uint64_t;
  static constexpr int W = 2;
  static __device__ __forceinline__ E zero() { return 0; }
  static __device__ __forceinline__ E one() { return 1; }
  static __device__ __forceinline__ E add(E a, E b) { return gl::add(a, b); }
  static __device__ __forceinline__ E sub(E a, E b) { return gl::sub(a, b); }
  static __device__ __forceinline__ E neg(E a) { return gl::neg(a); }
  static __device__ __forceinline__ E mul(E a, E b) { return gl::mul(a, b); }
  static __device__ __forceinline__ E load(const uint32_t* p) {
    return gl::load(p);
  }
  static __device__ __forceinline__ void store(uint32_t* p, E a) {
    gl::store(p, a);
  }
  static __device__ __forceinline__ E load_cg(const uint32_t* p) {
    return __ldcg(reinterpret_cast<const unsigned long long*>(p));
  }
  static __device__ __forceinline__ E shfl_up(E v, int d) {
    return __shfl_up_sync(0xffffffffu, (unsigned long long)v, d);
  }
  static __device__ __forceinline__ E shfl_down(E v, int d) {
    return __shfl_down_sync(0xffffffffu, (unsigned long long)v, d);
  }
  static __device__ __forceinline__ E shfl_xor(E v, int m) {
    return __shfl_xor_sync(0xffffffffu, (unsigned long long)v, m);
  }
};

struct GL3F {
  using E = gl3::E;
  static constexpr int W = 6;
  static __device__ __forceinline__ E zero() { return gl3::zero(); }
  static __device__ __forceinline__ E one() { return gl3::one(); }
  static __device__ __forceinline__ E add(const E& a, const E& b) {
    return gl3::add(a, b);
  }
  static __device__ __forceinline__ E sub(const E& a, const E& b) {
    return gl3::sub(a, b);
  }
  static __device__ __forceinline__ E neg(const E& a) { return gl3::neg(a); }
  static __device__ __forceinline__ E mul(const E& a, const E& b) {
    return gl3::mul(a, b);
  }
  static __device__ __forceinline__ E load(const uint32_t* p) {
    return gl3::load(p);
  }
  static __device__ __forceinline__ void store(uint32_t* p, const E& a) {
    gl3::store(p, a);
  }
  static __device__ __forceinline__ E load_cg(const uint32_t* p) {
    return {GLF::load_cg(p), GLF::load_cg(p + 2), GLF::load_cg(p + 4)};
  }
  static __device__ __forceinline__ E shfl_up(const E& v, int d) {
    return {GLF::shfl_up(v.c0, d), GLF::shfl_up(v.c1, d),
            GLF::shfl_up(v.c2, d)};
  }
  static __device__ __forceinline__ E shfl_down(const E& v, int d) {
    return {GLF::shfl_down(v.c0, d), GLF::shfl_down(v.c1, d),
            GLF::shfl_down(v.c2, d)};
  }
  static __device__ __forceinline__ E shfl_xor(const E& v, int m) {
    return {GLF::shfl_xor(v.c0, m), GLF::shfl_xor(v.c1, m),
            GLF::shfl_xor(v.c2, m)};
  }
};
