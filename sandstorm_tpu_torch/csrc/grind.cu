// Kernel: a window of the proof-of-work grind of the two verifier coins.
//
// Replaces the XLA routine sandstorm_tpu/crypto/grind.py:33 _grind_kernel
// (its jitted `step`, one batch of 2^16 nonces a dispatch): a launch covers
// `count` nonces from nonce0 (the wrapper's window, a whole number of
// 2^16-nonce batches), hashing prefix32 || nonce_be8 with Keccak-256
// (hash_id 0, the Solidity coin) or Blake2s-256 (hash_id 1, the Cairo
// coin).  A nonce passes when the digest's first four bytes, read
// big-endian, are below 2^(32 - bits) (zero at 32 bits).  out[0] gets the
// smallest passing offset, or 0xffffffff (the memset before the kernel)
// when none of the window's nonces passes.
//
// Bound on the H100: 32-bit ALU issue, one permutation (Keccak: 4,320
// instructions) or one compression (Blake2s: 1,136) for each nonce the
// answer needs, offset + 1 of them.  The earlier design launched one wave
// of 2^16 threads a batch and the host read out[0] after each, so a grind
// of k batches paid k launches and k round trips, and the wave's tail.
// Design: one launch a window, its grid BLOCKS_PER_SM blocks on every SM:
// 16 warps an SM keep the ALUs issuing through the hashes' independent
// chains, and a wave is 132 x 512 nonces, about one batch, so the early
// exit wastes at most about a wave (a grid at the card's full occupancy,
// 8 blocks an SM, hashed 270,336 nonces before its first check: 0.0255 ms
// for a hit at offset 80,136 on an H100 at 700 W).  Each block walks the
// window's 256-nonce chunks in increasing order, chunk blockIdx.x, then
// that plus the grid, ...; a passing thread atomicMin's its offset into
// out[0], and a block stops once out[0] lies below its next chunk.  The
// result is the smallest passing offset whatever order the blocks run in:
// the chunk that holds it is skipped only if a smaller passing offset is
// already in out[0], which cannot be.
#include <cuda_runtime.h>

#include <cstdint>

#include "blake2s.cuh"
#include "keccak.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

template <int HASH>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    grind_kernel(const uint32_t* __restrict__ prefix,
                 unsigned long long nonce0, int bits, uint32_t count,
                 uint32_t* out) {
  uint32_t pre[8];
#pragma unroll
  for (int k = 0; k < 8; k++) pre[k] = __ldg(prefix + k);
  const uint32_t stride = gridDim.x * THREADS;
  for (uint32_t base = blockIdx.x * THREADS; base < count; base += stride) {
    // a passing offset below this chunk already: nothing here can win
    if (*(volatile uint32_t*)out < base) return;
    const uint32_t t = base + threadIdx.x;
    const unsigned long long nonce = nonce0 + t;
    uint32_t m[10];
#pragma unroll
    for (int k = 0; k < 8; k++) m[k] = pre[k];
    // the nonce's eight big-endian bytes, as little-endian words of the
    // stream
    m[8] = bswap32((uint32_t)(nonce >> 32));
    m[9] = bswap32((uint32_t)nonce);
    uint32_t first;
    if constexpr (HASH == 0) {
      uint64_t a[25];
#pragma unroll
      for (int l = 0; l < 25; l++) a[l] = 0;
#pragma unroll
      for (int l = 0; l < 5; l++)
        a[l] = ((uint64_t)m[2 * l + 1] << 32) | m[2 * l];
      a[5] = 0x01u;                          // pad byte after the 40 bytes
      a[16] = 0x8000000000000000ull;         // 0x80 in the rate's last byte
      keccak::keccak_f(a);
      first = (uint32_t)a[0];
    } else {
      uint32_t h[8] = B2S_H0;
      uint32_t block[16];
#pragma unroll
      for (int k = 0; k < 16; k++) block[k] = k < 10 ? m[k] : 0u;
      blake2s::compress(h, block, 40, true);
      first = h[0];
    }
    const uint32_t lead = bswap32(first);
    const bool ok = bits < 32 ? lead < (1u << (32 - bits)) : lead == 0u;
    if (ok) atomicMin(out, t);
  }
}

template <int HASH>
int launch(const void* prefix_words, long long nonce0, int bits,
           long long count, void* out, cudaStream_t stream) {
  // BLOCKS_PER_SM blocks an SM, which the launch bounds let fit
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return (int)rc;
  const long long grid = (long long)sms * BLOCKS_PER_SM;
  const long long chunks = count / THREADS;
  const unsigned blocks =
      (unsigned)(chunks < grid ? chunks : grid);
  rc = cudaMemsetAsync(out, 0xff, sizeof(uint32_t), stream);
  if (rc != cudaSuccess) return (int)rc;
  grind_kernel<HASH><<<blocks, THREADS, 0, stream>>>(
      (const uint32_t*)prefix_words, (unsigned long long)nonce0, bits,
      (uint32_t)count, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// count: the window's nonces, a positive multiple of THREADS below 2^31
extern "C" int pow_grind(const void* prefix_words, long long nonce0, int bits,
                         int hash_id, long long count, void* out,
                         void* stream) {
  if (bits < 1 || bits > 32 || (hash_id != 0 && hash_id != 1) ||
      count < THREADS || count % THREADS || count >= (1LL << 31) ||
      nonce0 < 0)
    return (int)cudaErrorInvalidValue;
  if (hash_id == 0)
    return launch<0>(prefix_words, nonce0, bits, count, out,
                     (cudaStream_t)stream);
  return launch<1>(prefix_words, nonce0, bits, count, out,
                   (cudaStream_t)stream);
}
