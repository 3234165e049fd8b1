// Kernel: Keccak-256 (original padding 0x01) of many equal-length messages
// given as little-endian u32 words of their byte streams, with the
// MaskedKeccak256 digest mask fused.
//
// Replaces the XLA routines sandstorm_tpu/hashing/keccak.py:115
// keccak256_words, :158 keccak_hash_rows and :163 keccak_hash_node_pairs:
// the eth scheme's Merkle leaf hash of every committed row (W = 8 words a
// column: 40 on the plain layout's base trace, 56 on the recursive one's,
// 64 on a FRI layer's rows of eight) and of every node (W = 16).
//
// Layout: msg [n, W] u32, out [n, 8] u32.  A message is all 4 W bytes of
// its row; the pad (0x01 after the message, 0x80 in the last byte of the
// last block) is applied here, so W = 34 k takes k + 1 permutations.
// Digest words keep_words..7 are written as 0: keep_words = 5 is
// MaskedKeccak256<20> (the first 20 digest bytes survive), 8 no mask.
//
// Bound on the H100: 32-bit ALU issue.  A permutation is 24 rounds of
// about 180 32-bit instructions (three-input XORs and chi as one LOP3 a
// half-lane, a rotation as two funnel shifts), 4,320 in all, against 160
// or 64 bytes of message a row: a plain-layout row (two permutations)
// needs some 54 instructions a byte, so the bytes are no limit.
// Design: one thread per message, the whole state in registers
// (keccak.cuh), the rate absorbed block by block straight from the row.
#include <cuda_runtime.h>

#include <cstdint>

#include "keccak.cuh"

namespace {

__global__ void keccak_kernel(const uint32_t* __restrict__ msg, long long n,
                              int W, int keep_words,
                              uint32_t* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const uint32_t* row = msg + r * W;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = 0;
  const int nblocks = W / keccak::RATE_WORDS + 1;
  const int last_word = nblocks * keccak::RATE_WORDS - 1;
  for (int blk = 0; blk < nblocks; blk++) {
#pragma unroll
    for (int l = 0; l < keccak::RATE_WORDS / 2; l++) {
      const int i0 = blk * keccak::RATE_WORDS + 2 * l, i1 = i0 + 1;
      uint32_t w0 = i0 < W ? row[i0] : 0u;
      uint32_t w1 = i1 < W ? row[i1] : 0u;
      if (i0 == W) w0 ^= 0x01u;
      if (i1 == W) w1 ^= 0x01u;
      if (i1 == last_word) w1 ^= 0x80000000u;
      a[l] ^= ((uint64_t)w1 << 32) | w0;
    }
    keccak::keccak_f(a);
  }
  uint32_t* dst = out + r * 8;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const uint64_t lane = a[k / 2];
    const uint32_t w = (k & 1) ? (uint32_t)(lane >> 32) : (uint32_t)lane;
    dst[k] = k < keep_words ? w : 0u;
  }
}

}  // namespace

extern "C" int keccak_rows(const void* msg, long long n, int W, int keep_words,
                           void* out, void* stream) {
  if (W < 0 || keep_words < 0 || keep_words > 8)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const long long blocks = (n + 127) / 128;
    keccak_kernel<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)msg, n, W, keep_words, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
