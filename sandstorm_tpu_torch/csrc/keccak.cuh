// Keccak-f[1600] for one thread: the permutation of csrc/keccak.cu (Merkle
// rows and nodes) and csrc/grind.cu (the Solidity coin's proof of work).
//
// The 25 lanes are 64-bit values that the compiler keeps as register pairs;
// every lane index is a constant (the rho/pi step is written out, the 24
// rounds are 24 calls with literal round constants), so nothing goes to
// local memory.  A rotation is two funnel shifts on the halves, chi one
// LOP3 a half-lane.  Lane i is (x, y) = (i % 5, i / 5).
#pragma once

#include <cstdint>

namespace keccak {

// left rotation of a 64-bit lane by the constant R, as two funnel shifts
template <int R>
__device__ __forceinline__ uint64_t rotl(uint64_t x) {
  static_assert(R > 0 && R < 64, "rotation out of range");
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  uint32_t nlo, nhi;
  if constexpr (R < 32) {
    nhi = __funnelshift_l(lo, hi, R);
    nlo = __funnelshift_l(hi, lo, R);
  } else {
    nhi = __funnelshift_l(hi, lo, R - 32);
    nlo = __funnelshift_l(lo, hi, R - 32);
  }
  return ((uint64_t)nhi << 32) | nlo;
}

__device__ __forceinline__ void f_round(uint64_t a[25], uint64_t rc) {
  uint64_t c[5], b[25];
#pragma unroll
  for (int x = 0; x < 5; x++)  // theta
    c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
  for (int x = 0; x < 5; x++) {
    const uint64_t d = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);
#pragma unroll
    for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d;
  }
  // rho + pi: b[y + 5 ((2 x + 3 y) % 5)] = rotl(a[x + 5 y], rho(x, y))
  b[0] = a[0];
  b[1] = rotl<44>(a[6]);
  b[2] = rotl<43>(a[12]);
  b[3] = rotl<21>(a[18]);
  b[4] = rotl<14>(a[24]);
  b[5] = rotl<28>(a[3]);
  b[6] = rotl<20>(a[9]);
  b[7] = rotl<3>(a[10]);
  b[8] = rotl<45>(a[16]);
  b[9] = rotl<61>(a[22]);
  b[10] = rotl<1>(a[1]);
  b[11] = rotl<6>(a[7]);
  b[12] = rotl<25>(a[13]);
  b[13] = rotl<8>(a[19]);
  b[14] = rotl<18>(a[20]);
  b[15] = rotl<27>(a[4]);
  b[16] = rotl<36>(a[5]);
  b[17] = rotl<10>(a[11]);
  b[18] = rotl<15>(a[17]);
  b[19] = rotl<56>(a[23]);
  b[20] = rotl<62>(a[2]);
  b[21] = rotl<55>(a[8]);
  b[22] = rotl<39>(a[14]);
  b[23] = rotl<41>(a[15]);
  b[24] = rotl<2>(a[21]);
#pragma unroll
  for (int y = 0; y < 5; y++)  // chi
#pragma unroll
    for (int x = 0; x < 5; x++)
      a[x + 5 * y] =
          b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
  a[0] ^= rc;  // iota
}

__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
  f_round(a, 0x0000000000000001ull);
  f_round(a, 0x0000000000008082ull);
  f_round(a, 0x800000000000808Aull);
  f_round(a, 0x8000000080008000ull);
  f_round(a, 0x000000000000808Bull);
  f_round(a, 0x0000000080000001ull);
  f_round(a, 0x8000000080008081ull);
  f_round(a, 0x8000000000008009ull);
  f_round(a, 0x000000000000008Aull);
  f_round(a, 0x0000000000000088ull);
  f_round(a, 0x0000000080008009ull);
  f_round(a, 0x000000008000000Aull);
  f_round(a, 0x000000008000808Bull);
  f_round(a, 0x800000000000008Bull);
  f_round(a, 0x8000000000008089ull);
  f_round(a, 0x8000000000008003ull);
  f_round(a, 0x8000000000008002ull);
  f_round(a, 0x8000000000000080ull);
  f_round(a, 0x000000000000800Aull);
  f_round(a, 0x800000008000000Aull);
  f_round(a, 0x8000000080008081ull);
  f_round(a, 0x8000000000008080ull);
  f_round(a, 0x0000000080000001ull);
  f_round(a, 0x8000000080008008ull);
}

// the 136-byte rate, in u32 words
constexpr int RATE_WORDS = 34;

}  // namespace keccak
