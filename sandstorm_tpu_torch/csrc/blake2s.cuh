// Blake2s-256 compression (RFC 7693) for one thread: the compression of
// csrc/blake2s.cu (Merkle rows and nodes) and csrc/grind.cu (the Cairo
// coin's proof of work).  The state and the message block live in
// registers; the ten rounds are unrolled with constant message indices.
#pragma once

#include <cstdint>

namespace blake2s {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

#define B2S_G(a, b, c, d, x, y)                                            \
  a = a + b + (x);                                                         \
  d = rotr(d ^ a, 16);                                                     \
  c = c + d;                                                               \
  b = rotr(b ^ c, 12);                                                     \
  a = a + b + (y);                                                         \
  d = rotr(d ^ a, 8);                                                      \
  c = c + d;                                                               \
  b = rotr(b ^ c, 7);

#define B2S_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13,\
              s14, s15)                                                    \
  B2S_G(v0, v4, v8, v12, m[s0], m[s1])                                     \
  B2S_G(v1, v5, v9, v13, m[s2], m[s3])                                     \
  B2S_G(v2, v6, v10, v14, m[s4], m[s5])                                    \
  B2S_G(v3, v7, v11, v15, m[s6], m[s7])                                    \
  B2S_G(v0, v5, v10, v15, m[s8], m[s9])                                    \
  B2S_G(v1, v6, v11, v12, m[s10], m[s11])                                  \
  B2S_G(v2, v7, v8, v13, m[s12], m[s13])                                   \
  B2S_G(v3, v4, v9, v14, m[s14], m[s15])

__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16],
                                         uint64_t t, bool last) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
  uint32_t v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint32_t v8 = 0x6A09E667u, v9 = 0xBB67AE85u, v10 = 0x3C6EF372u,
           v11 = 0xA54FF53Au;
  uint32_t v12 = 0x510E527Fu ^ (uint32_t)t;
  uint32_t v13 = 0x9B05688Cu ^ (uint32_t)(t >> 32);
  uint32_t v14 = 0x1F83D9ABu ^ (last ? 0xFFFFFFFFu : 0u);
  uint32_t v15 = 0x5BE0CD19u;
  B2S_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  B2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  B2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  B2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  B2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  B2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  B2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  B2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  B2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  B2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  h[0] ^= v0 ^ v8;
  h[1] ^= v1 ^ v9;
  h[2] ^= v2 ^ v10;
  h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12;
  h[5] ^= v5 ^ v13;
  h[6] ^= v6 ^ v14;
  h[7] ^= v7 ^ v15;
}

// the initial chaining value of a 32-byte digest with no key
#define B2S_H0                                                             \
  {0x6A09E667u ^ 0x01010020u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,       \
   0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u}

}  // namespace blake2s
