// Kernel gl_open_dense: the dense OODS opener over Goldilocks (L = 2) and
// GF(p^3) (L = 6): every column at every point,
//     out[k][c] = sum_i cols[c][i] pt_k^i,   pt_k^i = hi[k][i >> log2 b]
//                                                     lo[k][i & (b - 1)],
// one template on the element (goldilocks.cuh GLF / GL3F).
//
// Replaces the JAX package's dense opener of the non-fp252 fields,
// sandstorm_tpu/stark/openings.py:32 _open_all_at_point (a dispatch a
// point: the outer product of the two power tables, then a multiply and a
// pairwise-add tree a column), whose power tables :20 _point_power_stack
// builds with prefix_mul (here gl_scan_mul, csrc/gl_scan.cu).
//
// Layout: cols [C, n, W] (a column's n rows contiguous), lo [K, b, W],
// hi [K, n / b, W], partial [K, C, nranges, W], out [K, C, W].
//
// Bound on the H100: operations.  A coefficient costs one product for its
// point's power and one a column (GF(p^3): 72 IMAD-pipe issues a product,
// GL: 8), against W x 4 bytes a column.  Design: a block is (point, group
// of up to GROUP columns, range of i): a thread forms pt^i = hi * lo once
// per i, in registers (never stored), and multiplies it into each column
// of its group, one accumulator a column; the block sums its threads
// (warp shuffles, then the warps' sums in shared memory) and writes one
// partial a (point, column, range); a second kernel of the same call sums
// the ranges' partials.  Field addition is exact and commutative, so the
// order of the sums changes no value.  Two kernels a call whatever K and
// n are (the wrapper counts the call once).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;   // OPEN_DENSE_THREADS in fields/gl_cuda.py
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 4;       // OPEN_DENSE_GROUP in fields/gl_cuda.py

template <class Fd>
__device__ __forceinline__ typename Fd::E warp_sum(typename Fd::E a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a = Fd::add(a, Fd::shfl_down(a, off));
  return a;
}

template <class Fd>
__global__ void __launch_bounds__(THREADS)
open_kernel(const uint32_t* __restrict__ cols, int C, long long n,
            const uint32_t* __restrict__ lo, int logb,
            const uint32_t* __restrict__ hi, int ngroups, long long chunk,
            uint32_t* __restrict__ partial) {
  using E = typename Fd::E;
  __shared__ E red[WARPS][GROUP];
  const int k = blockIdx.y / ngroups, c0 = (blockIdx.y % ngroups) * GROUP;
  const int nc = min(GROUP, C - c0);
  const long long nranges = gridDim.x, range = blockIdx.x;
  const long long b = 1LL << logb;
  const uint32_t* lok = lo + (long long)k * b * Fd::W;
  const uint32_t* hik = hi + (long long)k * (n >> logb) * Fd::W;
  E acc[GROUP];
#pragma unroll
  for (int q = 0; q < GROUP; q++) acc[q] = Fd::zero();
  const long long i1 = min(n, (range + 1) * chunk);
#pragma unroll 1
  for (long long i = range * chunk + threadIdx.x; i < i1; i += THREADS) {
    const E z = Fd::mul(Fd::load(hik + (i >> logb) * Fd::W),
                        Fd::load(lok + (i & (b - 1)) * Fd::W));
#pragma unroll
    for (int q = 0; q < GROUP; q++)
      if (q < nc)
        acc[q] = Fd::add(acc[q],
                         Fd::mul(Fd::load(cols + ((c0 + q) * n + i) * Fd::W),
                                 z));
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < GROUP; q++) {
    const E s = warp_sum<Fd>(acc[q]);
    if (lane == 0) red[w][q] = s;
  }
  __syncthreads();
  if (threadIdx.x < nc) {
    E s = red[0][threadIdx.x];
#pragma unroll 1
    for (int v = 1; v < WARPS; v++) s = Fd::add(s, red[v][threadIdx.x]);
    Fd::store(partial + (((long long)k * C + c0 + threadIdx.x) * nranges +
                         range) * Fd::W, s);
  }
}

// one thread a (point, column): the sum of its ranges' partials
template <class Fd>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const uint32_t* __restrict__ partial, long long pairs,
              long long nranges, uint32_t* __restrict__ out) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= pairs) return;
  const uint32_t* row = partial + p * nranges * Fd::W;
  typename Fd::E s = Fd::load(row);
#pragma unroll 1
  for (long long r = 1; r < nranges; r++)
    s = Fd::add(s, Fd::load(row + r * Fd::W));
  Fd::store(out + p * Fd::W, s);
}

template <class Fd>
int launch(const void* cols, int C, long long n, const void* lo, int logb,
           const void* hi, int K, long long nranges, long long chunk,
           void* partial, void* out, cudaStream_t s) {
  const int ngroups = (C + GROUP - 1) / GROUP;
  open_kernel<Fd><<<dim3((unsigned)nranges, (unsigned)(K * ngroups)),
                    THREADS, 0, s>>>(
      (const uint32_t*)cols, C, n, (const uint32_t*)lo, logb,
      (const uint32_t*)hi, ngroups, chunk, (uint32_t*)partial);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long pairs = (long long)K * C;
  reduce_kernel<Fd><<<(unsigned)((pairs + THREADS - 1) / THREADS), THREADS,
                      0, s>>>((const uint32_t*)partial, pairs, nranges,
                              (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// cols [C, n, L], lo [K, 2^logb, L], hi [K, n >> logb, L] words (L = 2:
// GL, 6: GF(p^3)); partial [K, C, nranges, L] scratch; out [K, C, L];
// nranges ranges of `chunk` rows cover n; K * ceil(C / GROUP) <= 65535
extern "C" int gl_open_dense(const void* cols, int C, long long n,
                             const void* lo, int logb, const void* hi, int K,
                             long long nranges, long long chunk, int L,
                             void* partial, void* out, void* stream) {
  if (L != 2 && L != 6) return (int)cudaErrorInvalidValue;
  if (C > 0 && K > 0 && n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    return L == 2 ? launch<GLF>(cols, C, n, lo, logb, hi, K, nranges, chunk,
                                partial, out, s)
                  : launch<GL3F>(cols, C, n, lo, logb, hi, K, nranges, chunk,
                                 partial, out, s);
  }
  return (int)cudaGetLastError();
}
