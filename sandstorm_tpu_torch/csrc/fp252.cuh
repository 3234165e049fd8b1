// Fp252 device arithmetic shared by every kernel of the port.
//
// An element is 8 little-endian u32 limbs of its Montgomery form (R = 2^256)
// for the Starkware prime p = 2^251 + 17*2^192 + 1.  In 32-bit limbs p is
// sparse: limb0 = 1, limb6 = 17, limb7 = 2^27, all others zero.  Every
// function takes canonical operands (< p) and returns a canonical result, so
// any correct sequence of instructions gives the same bits.
//
// Replaces the digit-register tile helpers of sandstorm_tpu/fields/
// fp252_pallas.py (_montmul_tile, _field_add_tile, _field_sub_tile,
// _cond_sub_p_tile), which split an element into sixteen 16-bit digits
// because the TPU's vector unit has no widening multiply.  The H100 has a
// 32x32 integer multiply-add with a carry flag, so the limbs here are 32
// bits wide and the carry chains of the product, the additions and the
// REDC's sums are PTX (mad.lo.cc / madc.hi.cc / addc.cc / subc.cc): one
// instruction per step, no 64-bit temporaries.
//
// Bound on the H100: the montmul is 64 schoolbook products, each a low and a
// high multiply on the IMAD pipe (36 for a square), plus the REDC.  Because
// p == 1 (mod 2^192), the first six REDC multipliers are the words of
// N6 = -T mod 2^192 (a negation, no multiplies), and the last two those of
// -T' mod 2^64;
// each group then adds N * (p >> 192) = N * (1 + 2^4 + 2^59) as three
// shifted copies, so the REDC needs no multiply and no round that carries
// through the upper half eight times.
#pragma once
#include <cstdint>

namespace fp {

struct F {
  uint32_t v[8];
};

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
  uint32_t borrow;
  asm("sub.cc.u32 %0, %9, 1;\n\t"
      "subc.cc.u32 %1, %10, 0;\n\t"
      "subc.cc.u32 %2, %11, 0;\n\t"
      "subc.cc.u32 %3, %12, 0;\n\t"
      "subc.cc.u32 %4, %13, 0;\n\t"
      "subc.cc.u32 %5, %14, 0;\n\t"
      "subc.cc.u32 %6, %15, 17;\n\t"
      "subc.cc.u32 %7, %16, 0x8000000;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
        "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]),
        "=r"(borrow)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
  F r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = borrow ? a.v[k] : d.v[k];
  return r;
}

static __device__ __forceinline__ F add(const F& a, const F& b) {
  F s;
  // a + b < 2p < 2^253: no carry leaves limb 7
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(s.v[0]), "=r"(s.v[1]), "=r"(s.v[2]), "=r"(s.v[3]),
        "=r"(s.v[4]), "=r"(s.v[5]), "=r"(s.v[6]), "=r"(s.v[7])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  return cond_sub_p(s);
}

// a - b, plus p where it borrowed (p's limbs masked by the borrow word)
static __device__ __forceinline__ F sub(const F& a, const F& b) {
  F d;
  uint32_t m;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]),
        "=r"(d.v[4]), "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(m)
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]),
        "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, %9;\n\t"
      "addc.u32 %7, %7, %10;"
      : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]),
        "+r"(d.v[4]), "+r"(d.v[5]), "+r"(d.v[6]), "+r"(d.v[7])
      : "r"(m & 1u), "r"(m & 17u), "r"(m & (1u << 27)));
  return d;
}

// t[0..8] += a * b (one row of the schoolbook product); t[8] is 0 on entry
// and the row's carry out of t[8] is 0 (the partial product fits).
static __device__ __forceinline__ void mac_row(uint32_t* t, const F& a,
                                               uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(b));
}

// t = a^2 in 16 limbs: the 28 products a_i a_j (i < j) once, doubled, plus
// the 8 squares a_i^2 (36 products where a product of two values takes 64)
static __device__ __forceinline__ void sqr_wide(uint32_t* t, const F& a) {
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
  // row 0: t[1..8] += a[1..7] * a[0]
  asm("mad.lo.cc.u32 %0, %8, %15, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %15, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %15, %2;\n\t"
      "madc.lo.cc.u32 %3, %11, %15, %3;\n\t"
      "madc.lo.cc.u32 %4, %12, %15, %4;\n\t"
      "madc.lo.cc.u32 %5, %13, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %14, %15, %6;\n\t"
      "addc.u32 %7, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %8, %15, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %15, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %15, %3;\n\t"
      "madc.hi.cc.u32 %4, %11, %15, %4;\n\t"
      "madc.hi.cc.u32 %5, %12, %15, %5;\n\t"
      "madc.hi.cc.u32 %6, %13, %15, %6;\n\t"
      "madc.hi.u32 %7, %14, %15, %7;"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(a.v[0]));
  // row 1: t[3..9] += a[2..7] * a[1]
  asm("mad.lo.cc.u32 %0, %7, %13, %0;\n\t"
      "madc.lo.cc.u32 %1, %8, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %13, %2;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.lo.cc.u32 %5, %12, %13, %5;\n\t"
      "addc.u32 %6, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %7, %13, %1;\n\t"
      "madc.hi.cc.u32 %2, %8, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %4, %10, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.hi.u32 %6, %12, %13, %6;"
      : "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(a.v[1]));
  // row 2: t[5..10] += a[3..7] * a[2]
  asm("mad.lo.cc.u32 %0, %6, %11, %0;\n\t"
      "madc.lo.cc.u32 %1, %7, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %8, %11, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %11, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %11, %4;\n\t"
      "addc.u32 %5, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %6, %11, %1;\n\t"
      "madc.hi.cc.u32 %2, %7, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %8, %11, %3;\n\t"
      "madc.hi.cc.u32 %4, %9, %11, %4;\n\t"
      "madc.hi.u32 %5, %10, %11, %5;"
      : "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10])
      : "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(a.v[2]));
  // row 3: t[7..11] += a[4..7] * a[3]
  asm("mad.lo.cc.u32 %0, %5, %9, %0;\n\t"
      "madc.lo.cc.u32 %1, %6, %9, %1;\n\t"
      "madc.lo.cc.u32 %2, %7, %9, %2;\n\t"
      "madc.lo.cc.u32 %3, %8, %9, %3;\n\t"
      "addc.u32 %4, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %5, %9, %1;\n\t"
      "madc.hi.cc.u32 %2, %6, %9, %2;\n\t"
      "madc.hi.cc.u32 %3, %7, %9, %3;\n\t"
      "madc.hi.u32 %4, %8, %9, %4;"
      : "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11])
      : "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(a.v[3]));
  // row 4: t[9..12] += a[5..7] * a[4]
  asm("mad.lo.cc.u32 %0, %4, %7, %0;\n\t"
      "madc.lo.cc.u32 %1, %5, %7, %1;\n\t"
      "madc.lo.cc.u32 %2, %6, %7, %2;\n\t"
      "addc.u32 %3, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %4, %7, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %7, %2;\n\t"
      "madc.hi.u32 %3, %6, %7, %3;"
      : "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
      : "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]), "r"(a.v[4]));
  // row 5: t[11..13] += a[6..7] * a[5]
  asm("mad.lo.cc.u32 %0, %3, %5, %0;\n\t"
      "madc.lo.cc.u32 %1, %4, %5, %1;\n\t"
      "addc.u32 %2, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %3, %5, %1;\n\t"
      "madc.hi.u32 %2, %4, %5, %2;"
      : "+r"(t[11]), "+r"(t[12]), "+r"(t[13])
      : "r"(a.v[6]), "r"(a.v[7]), "r"(a.v[5]));
  // row 6: t[13..14] += a[7..7] * a[6]
  asm("mad.lo.cc.u32 %0, %2, %3, %0;\n\t"
      "addc.u32 %1, 0, 0;\n\t"
      "mad.hi.u32 %1, %2, %3, %1;"
      : "+r"(t[13]), "+r"(t[14])
      : "r"(a.v[7]), "r"(a.v[6]));
  // double (the triangle is below 2^511), then add the squares
#pragma unroll
  for (int k = 15; k > 0; k--) t[k] = __funnelshift_l(t[k - 1], t[k], 1);
  t[0] = 0;
  asm("mad.lo.cc.u32 %0, %16, %16, %0;\n\t"
      "madc.hi.cc.u32 %1, %16, %16, %1;\n\t"
      "madc.lo.cc.u32 %2, %17, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %17, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %18, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %18, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %19, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %19, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %20, %20, %8;\n\t"
      "madc.hi.cc.u32 %9, %20, %20, %9;\n\t"
      "madc.lo.cc.u32 %10, %21, %21, %10;\n\t"
      "madc.hi.cc.u32 %11, %21, %21, %11;\n\t"
      "madc.lo.cc.u32 %12, %22, %22, %12;\n\t"
      "madc.hi.cc.u32 %13, %22, %22, %13;\n\t"
      "madc.lo.cc.u32 %14, %23, %23, %14;\n\t"
      "madc.hi.u32 %15, %23, %23, %15;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]),
        "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]),
        "+r"(t[15])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]),
        "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]));
}

// T * 2^-256 mod p for T = t[0..15] < p^2: M = N6 + 2^192 N2 with
// N6 = -T mod 2^192 and N2 = -(T + N6 p) / 2^192 mod 2^64 makes
// T + M p == 0 (mod 2^256), and (T + M p) / 2^256 < 2p.
static __device__ __forceinline__ F redc(uint32_t* t) {
  // N6 = -(t0..t5) = ~t_low + 1; T + N6 p = T + N6 + (N6 + N6 << 4) 2^192
  // + N6 2^251, and t_low + N6 carries c6 = (t_low != 0) into word 6.
  // The negation is C and c6 rides in the low bits of N6 << 4: with the
  // negation and c6 inside the PTX chains, ptxas (nvcc 12.9, -O1 and up)
  // got one result in seven wrong by 1 in limb 0 or 6 (right at -O0).
  uint32_t n[6];
  uint64_t c = 1;
#pragma unroll
  for (int k = 0; k < 6; k++) {
    c += (uint32_t)~t[k];
    n[k] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t c6 = (t[0] | t[1] | t[2] | t[3] | t[4] | t[5]) != 0;
  uint32_t s4[7], s27[7];
  s4[0] = (n[0] << 4) | c6;
  s27[0] = n[0] << 27;
#pragma unroll
  for (int k = 1; k < 6; k++) {
    s4[k] = __funnelshift_l(n[k - 1], n[k], 4);
    s27[k] = __funnelshift_l(n[k - 1], n[k], 27);
  }
  s4[6] = n[5] >> 28;
  s27[6] = n[5] >> 5;
  asm("add.cc.u32 %0, %0, %10;\n\t"
      "addc.cc.u32 %1, %1, %11;\n\t"
      "addc.cc.u32 %2, %2, %12;\n\t"
      "addc.cc.u32 %3, %3, %13;\n\t"
      "addc.cc.u32 %4, %4, %14;\n\t"
      "addc.cc.u32 %5, %5, %15;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.u32 %9, %9, 0;\n\t"
      "add.cc.u32 %0, %0, %16;\n\t"
      "addc.cc.u32 %1, %1, %17;\n\t"
      "addc.cc.u32 %2, %2, %18;\n\t"
      "addc.cc.u32 %3, %3, %19;\n\t"
      "addc.cc.u32 %4, %4, %20;\n\t"
      "addc.cc.u32 %5, %5, %21;\n\t"
      "addc.cc.u32 %6, %6, %22;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.u32 %9, %9, 0;\n\t"
      "add.cc.u32 %1, %1, %23;\n\t"
      "addc.cc.u32 %2, %2, %24;\n\t"
      "addc.cc.u32 %3, %3, %25;\n\t"
      "addc.cc.u32 %4, %4, %26;\n\t"
      "addc.cc.u32 %5, %5, %27;\n\t"
      "addc.cc.u32 %6, %6, %28;\n\t"
      "addc.cc.u32 %7, %7, %29;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.u32 %9, %9, 0;"
      : "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]),
        "+r"(t[11]), "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15])
      : "r"(n[0]), "r"(n[1]), "r"(n[2]), "r"(n[3]), "r"(n[4]), "r"(n[5]),
        "r"(s4[0]), "r"(s4[1]), "r"(s4[2]), "r"(s4[3]), "r"(s4[4]),
        "r"(s4[5]), "r"(s4[6]), "r"(s27[0]), "r"(s27[1]), "r"(s27[2]),
        "r"(s27[3]), "r"(s27[4]), "r"(s27[5]), "r"(s27[6]));
  // N2 = -(t6, t7): T' + N2 2^192 p = T' + N2 2^192 + (N2 + N2 << 4) 2^384
  // + N2 2^443; t6:t7 + N2 carries c8 = (t6:t7 != 0) into word 8
  c = 1;
  c += (uint32_t)~t[6];
  const uint32_t n6 = (uint32_t)c;
  c >>= 32;
  c += (uint32_t)~t[7];
  const uint32_t n7 = (uint32_t)c;
  const uint32_t c8 = (t[6] | t[7]) != 0;
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, %9;\n\t"
      "addc.cc.u32 %5, %5, %10;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.u32 %7, %7, 0;\n\t"
      "add.cc.u32 %4, %4, %11;\n\t"
      "addc.cc.u32 %5, %5, %12;\n\t"
      "addc.cc.u32 %6, %6, %13;\n\t"
      "addc.u32 %7, %7, 0;\n\t"
      "add.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.u32 %7, %7, %16;"
      : "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]),
        "+r"(t[13]), "+r"(t[14]), "+r"(t[15])
      : "r"(c8), "r"(n6), "r"(n7), "r"(n6 << 4),
        "r"(__funnelshift_l(n6, n7, 4)), "r"(n7 >> 28), "r"(n6 << 27),
        "r"(__funnelshift_l(n6, n7, 27)), "r"(n7 >> 5));
  F r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = t[8 + k];
  return cond_sub_p(r);
}

// a * b * 2^-256 mod p for a, b < p
static __device__ __forceinline__ F mul(const F& a, const F& b) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) mac_row(t + i, a, b.v[i]);
  return redc(t);
}

// e[0..9] += (a0 + a1 2^64 + a2 2^128 + a3 2^192) * b, where a0..a3 are
// every other limb of a factor: each lo / hi pair of a product lands on an
// even-aligned pair of words of one carry chain, which ptxas (sm_90a) emits
// as one IMAD.WIDE.U32.X a product; the carry out of e[9] is 0 where the
// sum fits (mul_wide's partial sums do).
static __device__ __forceinline__ void mac_pairs(uint32_t* e, uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint32_t b) {
  asm("mad.lo.cc.u32 %0, %10, %14, %0;\n\t"
      "madc.hi.cc.u32 %1, %10, %14, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %14, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %12, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %12, %14, %5;\n\t"
      "madc.lo.cc.u32 %6, %13, %14, %6;\n\t"
      "madc.hi.cc.u32 %7, %13, %14, %7;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.u32 %9, %9, 0;"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]),
        "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b));
}

// t[0..15] = a * b, unreduced.  The products a_j b_i of even column i + j
// go to A, those of odd column to B (B[k] holds column k + 1), so every
// chain of mac_pairs starts on an even word: a row i adds a's even limbs
// (i even) or odd limbs (i odd) into A and the others into B; one carry
// chain adds B one word up into A at the end.  mul's rows keep a
// product's lo and hi words on two chains, each word added by its own
// IADD3.X on the ALU pipe, which then holds a montmul back more than its
// multiplies do; here a product is one IMAD.WIDE.U32.X and no register
// moves realign the pairs (sandstorm_tpu_torch/tools/probe_montmul.py
// prints both forms' SASS counts and rates on the card).  deep.cu and the
// generated group kernels take this form; mul keeps the other kernels'
// code as it was.
static __device__ __forceinline__ void mul_wide(uint32_t* t, const F& a,
                                                const F& b) {
  uint32_t A[18], B[18];
#pragma unroll
  for (int k = 0; k < 18; k++) {
    A[k] = 0;
    B[k] = 0;
  }
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    mac_pairs(A + i, a.v[0], a.v[2], a.v[4], a.v[6], b.v[i]);
    mac_pairs(B + i, a.v[1], a.v[3], a.v[5], a.v[7], b.v[i]);
    mac_pairs(A + i + 2, a.v[1], a.v[3], a.v[5], a.v[7], b.v[i + 1]);
    mac_pairs(B + i, a.v[0], a.v[2], a.v[4], a.v[6], b.v[i + 1]);
  }
  t[0] = A[0];
  asm("add.cc.u32 %0, %15, %30;\n\t"
      "addc.cc.u32 %1, %16, %31;\n\t"
      "addc.cc.u32 %2, %17, %32;\n\t"
      "addc.cc.u32 %3, %18, %33;\n\t"
      "addc.cc.u32 %4, %19, %34;\n\t"
      "addc.cc.u32 %5, %20, %35;\n\t"
      "addc.cc.u32 %6, %21, %36;\n\t"
      "addc.cc.u32 %7, %22, %37;\n\t"
      "addc.cc.u32 %8, %23, %38;\n\t"
      "addc.cc.u32 %9, %24, %39;\n\t"
      "addc.cc.u32 %10, %25, %40;\n\t"
      "addc.cc.u32 %11, %26, %41;\n\t"
      "addc.cc.u32 %12, %27, %42;\n\t"
      "addc.cc.u32 %13, %28, %43;\n\t"
      "addc.u32 %14, %29, %44;"
      : "=r"(t[1]), "=r"(t[2]), "=r"(t[3]), "=r"(t[4]), "=r"(t[5]),
        "=r"(t[6]), "=r"(t[7]), "=r"(t[8]), "=r"(t[9]), "=r"(t[10]),
        "=r"(t[11]), "=r"(t[12]), "=r"(t[13]), "=r"(t[14]), "=r"(t[15])
      : "r"(A[1]), "r"(A[2]), "r"(A[3]), "r"(A[4]), "r"(A[5]), "r"(A[6]),
        "r"(A[7]), "r"(A[8]), "r"(A[9]), "r"(A[10]), "r"(A[11]),
        "r"(A[12]), "r"(A[13]), "r"(A[14]), "r"(A[15]), "r"(B[0]),
        "r"(B[1]), "r"(B[2]), "r"(B[3]), "r"(B[4]), "r"(B[5]), "r"(B[6]),
        "r"(B[7]), "r"(B[8]), "r"(B[9]), "r"(B[10]), "r"(B[11]),
        "r"(B[12]), "r"(B[13]), "r"(B[14]));
}

// acc[0..15] += t[0..15], one carry chain.  A sum of products of canonical
// operands stays a valid REDC input while it is below p 2^256: up to
// WIDE_TERMS products (16 p^2 < p 2^256 because 16 p < 2^256), so a dot
// product of up to WIDE_TERMS terms takes one redc in place of one each.
constexpr int WIDE_TERMS = 16;

static __device__ __forceinline__ void add_wide(uint32_t* acc,
                                                const uint32_t* t) {
  asm("add.cc.u32 %0, %0, %16;\n\t"
      "addc.cc.u32 %1, %1, %17;\n\t"
      "addc.cc.u32 %2, %2, %18;\n\t"
      "addc.cc.u32 %3, %3, %19;\n\t"
      "addc.cc.u32 %4, %4, %20;\n\t"
      "addc.cc.u32 %5, %5, %21;\n\t"
      "addc.cc.u32 %6, %6, %22;\n\t"
      "addc.cc.u32 %7, %7, %23;\n\t"
      "addc.cc.u32 %8, %8, %24;\n\t"
      "addc.cc.u32 %9, %9, %25;\n\t"
      "addc.cc.u32 %10, %10, %26;\n\t"
      "addc.cc.u32 %11, %11, %27;\n\t"
      "addc.cc.u32 %12, %12, %28;\n\t"
      "addc.cc.u32 %13, %13, %29;\n\t"
      "addc.cc.u32 %14, %14, %30;\n\t"
      "addc.u32 %15, %15, %31;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]),
        "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15])
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]), "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]),
        "r"(t[12]), "r"(t[13]), "r"(t[14]), "r"(t[15]));
}

// add_wide in plain C (64-bit sums): the version the PTX chain is held to
// on the card (csrc/fp252.cu fp252_dot, chip_smoke phase 3a')
static __device__ __forceinline__ void add_wide_c(uint32_t* acc,
                                                  const uint32_t* t) {
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 16; k++) {
    c += (uint64_t)acc[k] + t[k];
    acc[k] = (uint32_t)c;
    c >>= 32;
  }
}

// acc[0..15] += a * b
static __device__ __forceinline__ void mac_wide(uint32_t* acc, const F& a,
                                                const F& b) {
  uint32_t t[16];
  mul_wide(t, a, b);
  add_wide(acc, t);
}

// mul's value through mul_wide
static __device__ __forceinline__ F mul_wide_redc(const F& a, const F& b) {
  uint32_t t[16];
  mul_wide(t, a, b);
  return redc(t);
}

// a * a * 2^-256 mod p for a < p (mul(a, a), with fewer products)
static __device__ __forceinline__ F sqr(const F& a) {
  uint32_t t[16];
  sqr_wide(t, a);
  return redc(t);
}

}  // namespace fp

// Fp252 behind the interface of goldilocks.cuh's GLF / GL3F, for the
// kernels that take any of the three fields (fri.cu, scale_pad.cu): the
// element and its words, zero, add, sub, mul, loads and stores, and a
// multiplier X read by load_x and applied by scale (over GF(p^3) a
// base-field value; here an Fp252 element, so scale is mul)
struct FPF {
  using E = fp::F;
  using X = fp::F;
  static constexpr int W = 8;
  static __device__ __forceinline__ E zero() { return fp::zero(); }
  static __device__ __forceinline__ E add(const E& a, const E& b) {
    return fp::add(a, b);
  }
  static __device__ __forceinline__ E sub(const E& a, const E& b) {
    return fp::sub(a, b);
  }
  static __device__ __forceinline__ E mul(const E& a, const E& b) {
    return fp::mul_wide_redc(a, b);
  }
  static __device__ __forceinline__ E scale(const E& t, const X& s) {
    return fp::mul_wide_redc(t, s);
  }
  static __device__ __forceinline__ E load(const uint32_t* p) {
    return fp::load(p);
  }
  static __device__ __forceinline__ X load_x(const uint32_t* p) {
    return fp::load(p);
  }
  static __device__ __forceinline__ void store(uint32_t* p, const E& a) {
    fp::store(p, a);
  }
  // an element from words in any aligned memory (a kernel parameter)
  static __device__ __forceinline__ E from_words(const uint32_t* w) {
    E r;
#pragma unroll
    for (int k = 0; k < 8; k++) r.v[k] = w[k];
    return r;
  }
  static __device__ __forceinline__ X x_from_words(const uint32_t* w) {
    return from_words(w);
  }
};
