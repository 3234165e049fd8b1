// The Goldilocks NTT leaf: every radix-2 DIT stage of a batch of length-M
// Goldilocks transforms, each resident in shared memory.
//
// Replaces sandstorm_tpu/ntt/ntt_pallas.py:_mk_ntt_kernel("goldilocks")
// (:58, run by _ntt_leaf_call :101, butterflies from fields/gl_pallas.py
// gl_mul_tile / gl_add_tile / gl_sub_tile).  Every GL and GF(p^3)
// transform of the port runs through it: a GF(p^3) column is three GL
// columns on the batch axis (ntt/ntt.py).  The TPU kernel held a
// [2, M, 128] (lo, hi) block in VMEM with M <= 256; here M is capped by
// shared memory instead: M elements x 8 B, 64 KB at M = 8192.
//
// Layout: x and out are [M, B, 2] u32 (row m, transform b, lo/hi), natural
// order.  The kernel gathers rows in bit-reversed order while loading, runs
// log2 M stages in place, and writes natural-order output.  tw is the
// [M/2, 2] table of w_M^k (canonical); stage s reads w_M^((M >> s) * j).
//
// Bound on the H100: device memory at the leaf shapes the prover uses
// (log2 M Goldilocks multiplies per element, each a few 64-bit integer
// instructions, against 16 B in and out per element); the strided loads
// (rows B elements apart) cost more than the arithmetic.  Design: one block
// per transform, one radix-2 stage per barrier, elements as u64 in shared
// memory, the four-step driver in ntt/ntt_cuda.py around it.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int LOG_M_MAX = 13;

__global__ void gl_ntt_leaf_kernel(const uint32_t* __restrict__ x,
                                   uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ tw, int logM,
                                   long long B) {
  extern __shared__ uint64_t sm[];
  const int M = 1 << logM;
  const long long b = blockIdx.x;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    int src = (int)(__brev((unsigned)i) >> (32 - logM));
    sm[i] = gl::load(x + ((long long)src * B + b) * 2);
  }
  __syncthreads();
  for (int s = 1; s <= logM; s++) {
    const int half = 1 << (s - 1);
    for (int j = threadIdx.x; j < M / 2; j += blockDim.x) {
      int k = j & (half - 1);
      int i0 = ((j >> (s - 1)) << s) + k;
      int i1 = i0 + half;
      uint64_t u = sm[i0];
      uint64_t w = gl::load(tw + (long long)(k << (logM - s)) * 2);
      uint64_t t = gl::mul(sm[i1], w);
      sm[i0] = gl::add(u, t);
      sm[i1] = gl::sub(u, t);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    gl::store(out + ((long long)i * B + b) * 2, sm[i]);
}

}  // namespace

extern "C" int gl_ntt_leaf(const void* x, void* out, const void* tw, int logM,
                           long long B, void* stream) {
  if (logM < 1 || logM > LOG_M_MAX) return (int)cudaErrorInvalidValue;
  const int M = 1 << logM;
  const int smem = M * 8;
  cudaError_t err = cudaFuncSetAttribute(
      gl_ntt_leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    int threads = M / 2 < 512 ? M / 2 : 512;
    gl_ntt_leaf_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, logM, B);
  }
  return (int)cudaGetLastError();
}
