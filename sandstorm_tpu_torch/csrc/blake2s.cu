// Kernel 4: Blake2s-256 (RFC 7693, 32-byte digest, no key) of many
// equal-length messages given as little-endian u32 words.
//
// Replaces sandstorm_tpu/hashing/blake2s.py:blake2s_words (hash_rows,
// hash_node_pairs), which the JAX package left to XLA: the Merkle leaf hash
// of every committed row (W = 8 * columns words) and every node (W = 16).
//
// Layout: msg [n, W] u32, out [n, 8] u32; nbytes <= 4 W is the message
// length (words past it are treated as zero padding, per the spec).
//
// Bound on the H100: 32-bit add/xor/rotate throughput, ten rounds of eight
// G functions per 64-byte block; a row of the plain layout's base trace is
// 160 bytes, 3 blocks.  Design: one thread per message with the whole state
// and message block in registers (the schedule is unrolled with constant
// indices so nothing spills to local memory).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

#define G(a, b, c, d, x, y)       \
  a = a + b + (x);                \
  d = rotr(d ^ a, 16);            \
  c = c + d;                      \
  b = rotr(b ^ c, 12);            \
  a = a + b + (y);                \
  d = rotr(d ^ a, 8);             \
  c = c + d;                      \
  b = rotr(b ^ c, 7);

#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, \
              s14, s15)                                                   \
  G(v0, v4, v8, v12, m[s0], m[s1])                                        \
  G(v1, v5, v9, v13, m[s2], m[s3])                                        \
  G(v2, v6, v10, v14, m[s4], m[s5])                                       \
  G(v3, v7, v11, v15, m[s6], m[s7])                                       \
  G(v0, v5, v10, v15, m[s8], m[s9])                                       \
  G(v1, v6, v11, v12, m[s10], m[s11])                                     \
  G(v2, v7, v8, v13, m[s12], m[s13])                                      \
  G(v3, v4, v9, v14, m[s14], m[s15])

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
  ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  h[0] ^= v0 ^ v8;
  h[1] ^= v1 ^ v9;
  h[2] ^= v2 ^ v10;
  h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12;
  h[5] ^= v5 ^ v13;
  h[6] ^= v6 ^ v14;
  h[7] ^= v7 ^ v15;
}

__global__ void blake2s_kernel(const uint32_t* __restrict__ msg, long long n,
                               int W, int nbytes, uint32_t* __restrict__ out) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const uint32_t* row = msg + r * W;
  uint32_t h[8] = {0x6A09E667u ^ 0x01010020u, 0xBB67AE85u, 0x3C6EF372u,
                   0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu,
                   0x5BE0CD19u};
  const int nblocks = nbytes > 0 ? (nbytes + 63) / 64 : 1;
  for (int blk = 0; blk < nblocks; blk++) {
    uint32_t m[16];
#pragma unroll
    for (int w = 0; w < 16; w++) {
      int byte0 = (blk * 16 + w) * 4;
      uint32_t word = 0;
      if (byte0 < nbytes) {
        word = row[blk * 16 + w];
        int keep = nbytes - byte0;  // bytes of this word inside the message
        if (keep < 4) word &= (1u << (8 * keep)) - 1u;
      }
      m[w] = word;
    }
    bool last = blk == nblocks - 1;
    compress(h, m, last ? (uint64_t)nbytes : (uint64_t)(blk + 1) * 64, last);
  }
#pragma unroll
  for (int k = 0; k < 8; k++) out[r * 8 + k] = h[k];
}

}  // namespace

extern "C" int blake2s_rows(const void* msg, long long n, int W, int nbytes,
                            void* out, void* stream) {
  if (nbytes < 0 || nbytes > 4 * W) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    long long blocks = (n + 127) / 128;
    blake2s_kernel<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)msg, n, W, nbytes, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
