// Kernel: one batch of the proof-of-work grind of the two verifier coins.
//
// Replaces the XLA routine sandstorm_tpu/crypto/grind.py:33 _grind_kernel
// (its jitted `step`): thread t hashes prefix32 || nonce_be8 for nonce =
// nonce0 + t, t < GRIND_BATCH, with Keccak-256 (hash_id 0, the Solidity
// coin) or Blake2s-256 (hash_id 1, the Cairo coin).  A nonce passes when
// the digest's first four bytes, read big-endian, are below 2^(32 - bits)
// (zero at 32 bits).  A passing thread atomicMin's its offset t into out[0],
// which the caller sets to GRIND_BATCH (no hit) before the launch: the
// smallest passing offset lands there whatever order the blocks run in.
//
// Bound on the H100: 32-bit ALU issue, one permutation (Keccak: 4,320
// instructions) or one compression (Blake2s: 1,136) a nonce, 2^16 nonces:
// some 11 us of issue for Keccak at the card's add rate.  A grind is one or
// two such launches, each followed by the caller's read of out[0], so the
// launch and that synchronisation, not the hashing, set its time.
// Design: one thread per nonce, the 40-byte message built in registers
// from the prefix (the same eight words for every thread, read through the
// cache) and the nonce; the hashes are keccak.cuh's and blake2s.cuh's.
#include <cuda_runtime.h>

#include <cstdint>

#include "blake2s.cuh"
#include "keccak.cuh"

namespace {

constexpr int GRIND_BATCH = 1 << 16;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

template <int HASH>
__global__ void grind_kernel(const uint32_t* __restrict__ prefix,
                             unsigned long long nonce0, int bits,
                             uint32_t* __restrict__ out) {
  const uint32_t t = blockIdx.x * THREADS + threadIdx.x;
  const unsigned long long nonce = nonce0 + t;
  uint32_t m[10];
#pragma unroll
  for (int k = 0; k < 8; k++) m[k] = __ldg(prefix + k);
  // the nonce's eight big-endian bytes, as little-endian words of the stream
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
    a[5] = 0x01u;                            // pad byte after the 40 bytes
    a[16] = 0x8000000000000000ull;           // 0x80 in the rate's last byte
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

}  // namespace

extern "C" int pow_grind(const void* prefix_words, long long nonce0, int bits,
                         int hash_id, void* out, void* stream) {
  if (bits < 1 || bits > 32 || (hash_id != 0 && hash_id != 1))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = GRIND_BATCH / THREADS;
  if (hash_id == 0)
    grind_kernel<0><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)prefix_words, (unsigned long long)nonce0, bits,
        (uint32_t*)out);
  else
    grind_kernel<1><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)prefix_words, (unsigned long long)nonce0, bits,
        (uint32_t*)out);
  return (int)cudaGetLastError();
}
