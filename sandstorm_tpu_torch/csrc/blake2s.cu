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
// indices so nothing spills to local memory; the compression is
// blake2s.cuh's, which csrc/grind.cu shares).
#include <cuda_runtime.h>

#include <cstdint>

#include "blake2s.cuh"

namespace {

__global__ void blake2s_kernel(const uint32_t* __restrict__ msg, long long n,
                               int W, int nbytes, uint32_t* __restrict__ out) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const uint32_t* row = msg + r * W;
  uint32_t h[8] = B2S_H0;
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
    blake2s::compress(h, m,
                      last ? (uint64_t)nbytes : (uint64_t)(blk + 1) * 64,
                      last);
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
