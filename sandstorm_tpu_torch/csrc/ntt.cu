// Kernel 2: the NTT leaf -- every radix-2 DIT stage of a batch of length-M
// Fp252 transforms, each resident in shared memory.
//
// Replaces sandstorm_tpu/ntt/ntt_pallas.py:_mk_ntt_kernel("fp252") (run by
// _ntt_leaf_call).  The TPU kernel held a [16, M, 128] digit block in VMEM
// with M capped at 256 by its unrolled temporaries; here M is capped by
// shared memory instead: M elements x 32 B, 64 KB at M = 2048.
//
// Layout: x and out are [M, B, 8] u32 (row m, transform b, limb), natural
// order.  The kernel gathers rows in bit-reversed order while loading, runs
// log2 M stages in place, and writes natural-order output.  tw is the
// [M/2, 8] table of w_M^k (Montgomery); stage s reads w_M^((M >> s) * j).
//
// Bound on the H100: the log2 M montmuls per element (integer multiply
// throughput); each element crosses device memory once in and once out.
// Design: one block per transform, limbs stored limb-major in shared memory
// (word w of element i at smem[w * M + i]) so neighbouring threads hit
// neighbouring banks; the four-step code in ntt_cuda.py splits longer
// transforms into leaves, a twiddle multiply (kernel 1) and a transpose.
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

__device__ __forceinline__ fp::F sload(const uint32_t* smem, int M, int i) {
  fp::F r;
#pragma unroll
  for (int w = 0; w < 8; w++) r.v[w] = smem[w * M + i];
  return r;
}

__device__ __forceinline__ void sstore(uint32_t* smem, int M, int i,
                                       const fp::F& a) {
#pragma unroll
  for (int w = 0; w < 8; w++) smem[w * M + i] = a.v[w];
}

__global__ void ntt_leaf_kernel(const uint32_t* __restrict__ x,
                                uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ tw, int logM,
                                long long B) {
  extern __shared__ uint32_t smem[];
  const int M = 1 << logM;
  const long long b = blockIdx.x;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    int src = (int)(__brev((unsigned)i) >> (32 - logM));
    sstore(smem, M, i, fp::load(x + ((long long)src * B + b) * 8));
  }
  __syncthreads();
  for (int s = 1; s <= logM; s++) {
    const int half = 1 << (s - 1);
    for (int j = threadIdx.x; j < M / 2; j += blockDim.x) {
      int k = j & (half - 1);
      int i0 = ((j >> (s - 1)) << s) + k;
      int i1 = i0 + half;
      fp::F u = sload(smem, M, i0);
      fp::F t = fp::mul(sload(smem, M, i1),
                        fp::load(tw + (long long)(k << (logM - s)) * 8));
      sstore(smem, M, i0, fp::add(u, t));
      sstore(smem, M, i1, fp::sub(u, t));
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    fp::store(out + ((long long)i * B + b) * 8, sload(smem, M, i));
}

}  // namespace

extern "C" int ntt_leaf(const void* x, void* out, const void* tw, int logM,
                        long long B, void* stream) {
  if (logM < 1 || logM > 11) return (int)cudaErrorInvalidValue;
  const int M = 1 << logM;
  const int smem = M * 32;
  cudaError_t err = cudaFuncSetAttribute(
      ntt_leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    int threads = M / 2 < 512 ? M / 2 : 512;
    ntt_leaf_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, logM, B);
  }
  return (int)cudaGetLastError();
}
