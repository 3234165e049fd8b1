// Kernel 3: the pair-indexed OODS opener.  For each requested (point k,
// column c) pair it computes sum_i cols[c][i] * pt_k^i, with
// pt_k^i = hi[k][i >> log2 b] * lo[k][i & (b - 1)].
//
// Replaces sandstorm_tpu/fields/fp252_pallas.py:open_pairs_partials (body
// _open_pairs_kernel), which walked the coefficient axis as a sequential grid
// and carried [P, 16, 8, 128] partial sums across grid steps, leaving the
// final reduction to the host (stark/openings.py:79-84).  Here blocks run in
// parallel and carry nothing, so the reduction is two launches: a 2-D grid
// over (chunk of i, pair) writes one partial per block after a shared-memory
// tree reduction, then one block per pair sums its partials.  Field addition
// has no atomic form.
//
// Layout: cols [C, n, 8], lo [K, b, 8], hi [K, n / b, 8] (Montgomery), kidx
// and cidx [P] int32 read by each block itself, partial [P, nchunks, 8],
// out [P, 8].
//
// Bound on the H100: two montmuls and one add per (pair, i), so integer
// multiply throughput; the column data is re-read once per pair that names
// it (through L2).
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

constexpr int THREADS = 256;

__device__ void block_reduce_store(fp::F acc, uint32_t* dst) {
  __shared__ uint32_t sm[8][THREADS];
#pragma unroll
  for (int w = 0; w < 8; w++) sm[w][threadIdx.x] = acc.v[w];
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      fp::F a, b;
#pragma unroll
      for (int w = 0; w < 8; w++) {
        a.v[w] = sm[w][threadIdx.x];
        b.v[w] = sm[w][threadIdx.x + s];
      }
      a = fp::add(a, b);
#pragma unroll
      for (int w = 0; w < 8; w++) sm[w][threadIdx.x] = a.v[w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    fp::F r;
#pragma unroll
    for (int w = 0; w < 8; w++) r.v[w] = sm[w][0];
    fp::store(dst, r);
  }
}

__global__ void open_pairs_partial_kernel(
    const uint32_t* __restrict__ cols, long long n,
    const uint32_t* __restrict__ lo, int logb,
    const uint32_t* __restrict__ hi, const int* __restrict__ kidx,
    const int* __restrict__ cidx, long long chunk,
    uint32_t* __restrict__ partial) {
  const int p = blockIdx.y;
  const long long b = 1LL << logb;
  const long long a = n >> logb;
  const uint32_t* col = cols + (long long)cidx[p] * n * 8;
  const uint32_t* lok = lo + (long long)kidx[p] * b * 8;
  const uint32_t* hik = hi + (long long)kidx[p] * a * 8;
  long long start = (long long)blockIdx.x * chunk;
  long long end = start + chunk < n ? start + chunk : n;
  fp::F acc = fp::zero();
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    fp::F z = fp::mul(fp::load(hik + (i >> logb) * 8),
                      fp::load(lok + (i & (b - 1)) * 8));
    acc = fp::add(acc, fp::mul(fp::load(col + i * 8), z));
  }
  block_reduce_store(acc, partial + ((long long)p * gridDim.x + blockIdx.x) * 8);
}

__global__ void open_pairs_reduce_kernel(const uint32_t* __restrict__ partial,
                                         int nchunks,
                                         uint32_t* __restrict__ out) {
  const int p = blockIdx.x;
  fp::F acc = fp::zero();
  for (int j = threadIdx.x; j < nchunks; j += THREADS)
    acc = fp::add(acc, fp::load(partial + ((long long)p * nchunks + j) * 8));
  block_reduce_store(acc, out + (long long)p * 8);
}

}  // namespace

extern "C" int open_pairs_partial(const void* cols, long long n,
                                  const void* lo, int logb, const void* hi,
                                  const void* kidx, const void* cidx,
                                  int num_pairs, int nchunks, long long chunk,
                                  void* partial, void* stream) {
  if (num_pairs > 0 && nchunks > 0) {
    dim3 grid((unsigned)nchunks, (unsigned)num_pairs);
    open_pairs_partial_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)cols, n, (const uint32_t*)lo, logb,
        (const uint32_t*)hi, (const int*)kidx, (const int*)cidx, chunk,
        (uint32_t*)partial);
  }
  return (int)cudaGetLastError();
}

extern "C" int open_pairs_reduce(const void* partial, int num_pairs,
                                 int nchunks, void* out, void* stream) {
  if (num_pairs > 0) {
    open_pairs_reduce_kernel<<<(unsigned)num_pairs, THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const uint32_t*)partial, nchunks, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
