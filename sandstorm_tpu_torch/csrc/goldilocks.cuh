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

// lo + hi 2^64 (any 128-bit value) mod p
static __device__ __forceinline__ uint64_t reduce128(uint64_t lo,
                                                     uint64_t hi) {
  const uint64_t w2 = hi & 0xFFFFFFFFull, w3 = hi >> 32;
  uint64_t t = lo - w3;              // w3 * 2^96 = -w3 (mod p)
  if (lo < w3) t -= EPS;             // fold the borrow
  const uint64_t t1 = w2 * EPS;      // w2 * 2^64 = w2 * (2^32 - 1), < 2^64
  uint64_t r = t + t1;
  if (r < t) r += EPS;               // fold the carry
  return cond_sub_p(r);
}

static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

static __device__ __forceinline__ uint64_t neg(uint64_t a) {
  return sub(0, a);
}

// A sum of products kept unreduced, lo + hi 2^64 + c 2^128, reduced once
// at its end: the folds of the generated group kernels and the opener's
// sums over a thread's coefficients.  The carries are compares and adds
// in C (ptxas miscompiled long PTX add.cc / addc chains on nvcc 12.9 for
// sm_90a: csrc/fp252.cuh).  A product of two canonical values is below
// (p - 1)^2, so its high word is at most 2^64 - 2^33 + 1 and takes the
// carry of the low word without wrapping; c counts at most one carry a
// term, so any sum of fewer than 2^32 terms fits.
struct Wide {
  uint64_t lo, hi;
  uint32_t c;
};

static __device__ __forceinline__ Wide wide_zero() { return {0, 0, 0}; }

// w += a b (a, b canonical)
static __device__ __forceinline__ void mac(Wide& w, uint64_t a, uint64_t b) {
  const uint64_t l = a * b;
  w.lo += l;
  const uint64_t h = __umul64hi(a, b) + (w.lo < l);
  w.hi += h;
  w.c += w.hi < h;
}

// w += a (a < 2^64)
static __device__ __forceinline__ void acc(Wide& w, uint64_t a) {
  w.lo += a;
  const uint64_t k = w.lo < a;
  w.hi += k;
  w.c += w.hi < k;
}

// the sum mod p: 2^64 = 2^32 - 1 and 2^96 = -1 in reduce128, then
// 2^128 = -2^32, and c 2^32 < p because c < 2^32
static __device__ __forceinline__ uint64_t reduce(const Wide& w) {
  return sub(reduce128(w.lo, w.hi), (uint64_t)w.c << 32);
}

// a^-1 = a^(p - 2) (Fermat; 0 for 0) by a fixed addition chain of 64
// squarings and 9 products: t_k = a^(2^k - 1) from t_j^(2^i) t_i =
// t_(j + i), then p - 2 = (2^31 - 1) 2^33 + (2^32 - 1), so the inverse is
// t_31^(2^33) t_32.  The batch inversion's one inversion a tile and
// column (csrc/gl_scan.cu): about 73 dependent products.
static __device__ __forceinline__ uint64_t sqn(uint64_t a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; i++) a = mul(a, a);
  return a;
}

static __device__ __forceinline__ uint64_t inv(uint64_t a) {
  const uint64_t t1 = a;
  const uint64_t t2 = mul(mul(t1, t1), t1);
  const uint64_t t3 = mul(mul(t2, t2), t1);
  const uint64_t t6 = mul(sqn(t3, 3), t3);
  const uint64_t t12 = mul(sqn(t6, 6), t6);
  const uint64_t t24 = mul(sqn(t12, 12), t12);
  const uint64_t t30 = mul(sqn(t24, 6), t6);
  const uint64_t t31 = mul(mul(t30, t30), t1);
  const uint64_t t32 = mul(mul(t31, t31), t1);
  return mul(sqn(t31, 33), t32);
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

// The forms of the typed kernels (the generated group kernels and the
// opener), each giving mul's words: a base-field value is one canonical
// u64, and an element whose upper coordinates are zero multiplies as
// three Goldilocks products.  mul_base(a, b) = mul(a, (b, 0, 0)).
static __device__ __forceinline__ E mul_base(const E& a, uint64_t b) {
  return {gl::mul(a.c0, b), gl::mul(a.c1, b), gl::mul(a.c2, b)};
}

// a + b, a - b and b - a for a base value b: only c0 meets b (the upper
// coordinates of b - a are negated, as sub((b, 0, 0), a) negates them)
static __device__ __forceinline__ E add_base(const E& a, uint64_t b) {
  return {gl::add(a.c0, b), a.c1, a.c2};
}

static __device__ __forceinline__ E sub_base(const E& a, uint64_t b) {
  return {gl::sub(a.c0, b), a.c1, a.c2};
}

static __device__ __forceinline__ E base_sub(uint64_t b, const E& a) {
  return {gl::sub(b, a.c0), gl::neg(a.c1), gl::neg(a.c2)};
}

// A sum of GF(p^3) products kept unreduced: a gl::Wide a coordinate.
struct W3 {
  gl::Wide c0, c1, c2;
};

static __device__ __forceinline__ W3 w3_zero() {
  return {gl::wide_zero(), gl::wide_zero(), gl::wide_zero()};
}

// b with its doubled upper coordinates, for the products that x^3 = 2
// folds into the lower ones: a b = (a0 b0 + a1 2b2 + a2 2b1,
// a0 b1 + a1 b0 + a2 2b2, a0 b2 + a1 b1 + a2 b0)
struct Dbl {
  E v;
  uint64_t d1, d2;
};

static __device__ __forceinline__ Dbl dbl(const E& b) {
  return {b, gl::add(b.c1, b.c1), gl::add(b.c2, b.c2)};
}

// w += a b: the schoolbook's 9 products, unreduced
static __device__ __forceinline__ void mac(W3& w, const E& a, const Dbl& b) {
  gl::mac(w.c0, a.c0, b.v.c0);
  gl::mac(w.c0, a.c1, b.d2);
  gl::mac(w.c0, a.c2, b.d1);
  gl::mac(w.c1, a.c0, b.v.c1);
  gl::mac(w.c1, a.c1, b.v.c0);
  gl::mac(w.c1, a.c2, b.d2);
  gl::mac(w.c2, a.c0, b.v.c2);
  gl::mac(w.c2, a.c1, b.v.c1);
  gl::mac(w.c2, a.c2, b.v.c0);
}

// w += a b for a base value b: 3 products
static __device__ __forceinline__ void mac_base(W3& w, const E& a,
                                                uint64_t b) {
  gl::mac(w.c0, a.c0, b);
  gl::mac(w.c1, a.c1, b);
  gl::mac(w.c2, a.c2, b);
}

static __device__ __forceinline__ void acc(W3& w, const E& a) {
  gl::acc(w.c0, a.c0);
  gl::acc(w.c1, a.c1);
  gl::acc(w.c2, a.c2);
}

static __device__ __forceinline__ E reduce(const W3& w) {
  return {gl::reduce(w.c0), gl::reduce(w.c1), gl::reduce(w.c2)};
}

// GL3.mul: the schoolbook's 9 products, those that x^3 = 2 folds into the
// lower coordinates taken by the doubled coordinates of b, summed
// unreduced, one reduction a coordinate (each coordinate is the canonical
// value of the same sum as GL3.mul's, so the words are GL3.mul's)
static __device__ __forceinline__ E mul(const E& a, const E& b) {
  W3 w = w3_zero();
  mac(w, a, dbl(b));
  return reduce(w);
}

// The Frobenius maps x -> x^p and x -> x^(p^2): with x^3 = 2 they scale
// coordinate 1 by OMEGA (OMEGA^2) and coordinate 2 by OMEGA^2 (OMEGA),
// OMEGA = 2^((p - 1) / 3) = 2^32 - 1, a primitive cube root of 1
constexpr uint64_t OMEGA = 0xFFFFFFFFull;
constexpr uint64_t OMEGA2 = 0xFFFFFFFE00000001ull;  // OMEGA^2 mod p

static __device__ __forceinline__ E frob(const E& a) {
  return {a.c0, gl::mul(a.c1, OMEGA), gl::mul(a.c2, OMEGA2)};
}

static __device__ __forceinline__ E frob2(const E& a) {
  return {a.c0, gl::mul(a.c1, OMEGA2), gl::mul(a.c2, OMEGA)};
}

// The norm N(a) = a a^p a^(p^2), which lies in GF(p), with t = a^p a^(p^2)
// beside it, so that a^-1 = t N(a)^-1 (0 for 0: N(a) = 0 only for a = 0),
// the inverse of the host's Fq3S.inv (fields/gl3.py): one GF(p^3) product
// and the 3 products of a t's c0 (its upper coordinates vanish),
// a0 t0 + 2 (a1 t2 + a2 t1)
static __device__ __forceinline__ uint64_t norm(const E& a, E& t) {
  t = mul(frob(a), frob2(a));
  const uint64_t cross = gl::add(gl::mul(a.c1, t.c2), gl::mul(a.c2, t.c1));
  return gl::add(gl::mul(a.c0, t.c0), gl::add(cross, cross));
}



}  // namespace gl3

// The two fields behind one interface, for the kernels that take either
// (templates on the field: gl_scan.cu, gl_deep.cu, gl_open.cu, and the
// generated group kernels of air/codegen.py): the element and its words,
// zero and one, the field operations above, the norm into GF(p) by which
// an element is inverted (gl::inv of its norm), loads and stores, an L2
// load
// (a value another block published in the same launch) and warp shuffles;
// a base-field multiplier X (load_x, scale; the FRI fold's and the coset
// scale's tables) and elements and multipliers from kernel parameters
// (from_words, x_from_words);
// for the typed kernels, an unreduced sum A of products by a multiplier
// prepared once (D: GF(p^3)'s doubled upper coordinates), by an element
// (mac) or a base-field value (mac_base), of elements (acc), and its
// reduction.
struct GLF {
  using E = uint64_t;
  using A = gl::Wide;
  using D = uint64_t;
  using X = uint64_t;   // a base-field multiplier (scale, load_x)
  static constexpr int W = 2;
  static __device__ __forceinline__ A a_zero() { return gl::wide_zero(); }
  static __device__ __forceinline__ D prep(E z) { return z; }
  static __device__ __forceinline__ void mac(A& w, E a, D z) {
    gl::mac(w, a, z);
  }
  static __device__ __forceinline__ void mac_base(A& w, D z, uint64_t b) {
    gl::mac(w, z, b);
  }
  static __device__ __forceinline__ void acc(A& w, E a) { gl::acc(w, a); }
  static __device__ __forceinline__ E reduce(const A& w) {
    return gl::reduce(w);
  }
  static __device__ __forceinline__ E zero() { return 0; }
  static __device__ __forceinline__ E one() { return 1; }
  static __device__ __forceinline__ E add(E a, E b) { return gl::add(a, b); }
  static __device__ __forceinline__ E sub(E a, E b) { return gl::sub(a, b); }
  static __device__ __forceinline__ E neg(E a) { return gl::neg(a); }
  static __device__ __forceinline__ E mul(E a, E b) { return gl::mul(a, b); }
  // a^-1 = scale(t, N(a)^-1) with N(a) = norm(a, t) in GF(p): over GL the
  // norm is a itself and t is 1
  static __device__ __forceinline__ uint64_t norm(E a, E& t) {
    t = 1;
    return a;
  }
  static __device__ __forceinline__ E scale(E t, uint64_t s) {
    return gl::mul(t, s);
  }
  static __device__ __forceinline__ E load(const uint32_t* p) {
    return gl::load(p);
  }
  static __device__ __forceinline__ void store(uint32_t* p, E a) {
    gl::store(p, a);
  }
  static __device__ __forceinline__ X load_x(const uint32_t* p) {
    return gl::load(p);
  }
  // an element (a multiplier) from u32 words in any memory, 4-byte
  // aligned (a kernel parameter)
  static __device__ __forceinline__ E from_words(const uint32_t* w) {
    return (uint64_t)w[0] | (uint64_t)w[1] << 32;
  }
  static __device__ __forceinline__ X x_from_words(const uint32_t* w) {
    return from_words(w);
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
  using A = gl3::W3;
  using D = gl3::Dbl;
  using X = uint64_t;   // a base-field multiplier (scale, load_x)
  static constexpr int W = 6;
  static __device__ __forceinline__ A a_zero() { return gl3::w3_zero(); }
  static __device__ __forceinline__ D prep(const E& z) { return gl3::dbl(z); }
  static __device__ __forceinline__ void mac(A& w, const E& a, const D& z) {
    gl3::mac(w, a, z);
  }
  static __device__ __forceinline__ void mac_base(A& w, const D& z,
                                                  uint64_t b) {
    gl3::mac_base(w, z.v, b);
  }
  static __device__ __forceinline__ void acc(A& w, const E& a) {
    gl3::acc(w, a);
  }
  static __device__ __forceinline__ E reduce(const A& w) {
    return gl3::reduce(w);
  }
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
  static __device__ __forceinline__ uint64_t norm(const E& a, E& t) {
    return gl3::norm(a, t);
  }
  static __device__ __forceinline__ E scale(const E& t, uint64_t s) {
    return gl3::mul_base(t, s);
  }
  static __device__ __forceinline__ E load(const uint32_t* p) {
    return gl3::load(p);
  }
  static __device__ __forceinline__ void store(uint32_t* p, const E& a) {
    gl3::store(p, a);
  }
  static __device__ __forceinline__ X load_x(const uint32_t* p) {
    return gl::load(p);
  }
  static __device__ __forceinline__ E from_words(const uint32_t* w) {
    return {GLF::from_words(w), GLF::from_words(w + 2),
            GLF::from_words(w + 4)};
  }
  static __device__ __forceinline__ X x_from_words(const uint32_t* w) {
    return GLF::from_words(w);
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
