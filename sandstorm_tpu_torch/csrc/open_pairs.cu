// Kernel 3: the pair-indexed OODS opener.  For each requested (point k,
// column c) pair it computes sum_i cols[c][i] * pt_k^i, with
// pt_k^i = hi[k][i >> log2 b] * lo[k][i & (b - 1)].
//
// Replaces sandstorm_tpu/fields/fp252_pallas.py:open_pairs_partials (body
// _open_pairs_kernel), which walked the coefficient axis as a sequential grid
// and carried [P, 16, 8, 128] partial sums across grid steps, leaving the
// final reduction to the host (stark/openings.py:79-84).
//
// Layout: cols [C, n, 8], lo [K, b, 8], hi [K, n / b, 8] (Montgomery).  The
// wrapper (fields/fp252_cuda.py:pair_groups) sorts the pairs into groups: one
// point and up to GROUP of its columns.  groups is [ngroups, 2 + 2 GROUP]
// int32: the point k, the number of columns, their indices, and the position
// of each (k, column) pair in the caller's list.  partial is
// [ngroups, nranges, GROUP, 8] scratch, counters [ngroups] zeros, out [P, 8].
//
// Bound on the H100: integer multiply throughput.  The arithmetic needs one
// montmul per (pair, i) and one per (point, i) for the point's power.
// Design against it:
//  - a block is (group, range of i): a thread computes z = hi * lo once per
//    i and multiplies it into each of the group's columns, one accumulator
//    per column in registers, so a coefficient costs P + (number of groups)
//    montmuls over all pairs, not 2 P;
//  - the grid is sized to the card (a few blocks an SM) and each block
//    strides over its whole range, so the block reduction -- warp shuffles
//    of the limbs, then one pass over the warps' sums in shared memory --
//    runs once per (block, column);
//  - one launch: the last block of a group to finish (a device counter
//    behind __threadfence) sums the group's partials, a warp per column,
//    lanes over the ranges in index order, and writes the pairs' values.
//    Field addition has no atomic form; the order of the sum is fixed by
//    index, never by arrival.
//  Blocks of one range are neighbours in the grid (the group is the fast
//  index), so the groups that name a column read it while it is in L2.
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 4;       // columns a block accumulates: 32 registers
constexpr int MIN_BLOCKS = 3;  // blocks an SM, caps the registers at 85
constexpr int ROW = 2 + 2 * GROUP;
static_assert(WARPS >= GROUP, "the final sum takes a warp per column");

// sum over the warp's lanes, in lane 0 (a tree by lane index)
__device__ __forceinline__ fp::F warp_sum(fp::F a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    fp::F b;
#pragma unroll
    for (int w = 0; w < 8; w++)
      b.v[w] = __shfl_down_sync(0xffffffffu, a.v[w], off);
    a = fp::add(a, b);
  }
  return a;
}

// an element another block wrote in this launch: read through L2
__device__ __forceinline__ fp::F load_cg(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 x = __ldcg(q), y = __ldcg(q + 1);
  fp::F r;
  r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  r.v[4] = y.x; r.v[5] = y.y; r.v[6] = y.z; r.v[7] = y.w;
  return r;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
open_pairs_kernel(const uint32_t* __restrict__ cols, long long n,
                  const uint32_t* __restrict__ lo, int logb,
                  const uint32_t* __restrict__ hi,
                  const int* __restrict__ groups, long long chunk,
                  uint32_t* partial, int* counters,
                  uint32_t* __restrict__ out) {
  __shared__ uint32_t red[WARPS][GROUP][8];
  __shared__ long long coloff[GROUP];
  __shared__ int last;
  const int grp = blockIdx.x, range = blockIdx.y, nranges = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* row = groups + (long long)grp * ROW;
  const int k = row[0], ncols = row[1];
  const long long b = 1LL << logb;
  if (threadIdx.x < GROUP)
    coloff[threadIdx.x] =
        threadIdx.x < ncols ? (long long)row[2 + threadIdx.x] * n * 8 : 0;
  __syncthreads();
  const uint32_t* lok = lo + (long long)k * b * 8;
  const uint32_t* hik = hi + (long long)k * (n >> logb) * 8;
  const long long start = (long long)range * chunk;
  const long long end = start + chunk < n ? start + chunk : n;

  fp::F acc[GROUP];
#pragma unroll
  for (int c = 0; c < GROUP; c++) acc[c] = fp::zero();
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    const fp::F z = fp::mul(fp::load(hik + (i >> logb) * 8),
                            fp::load(lok + (i & (b - 1)) * 8));
#pragma unroll
    for (int c = 0; c < GROUP; c++)
      if (c < ncols)
        acc[c] = fp::add(acc[c],
                         fp::mul(fp::load(cols + coloff[c] + i * 8), z));
  }

  // the block's sum per column: lanes, then warps in index order
#pragma unroll
  for (int c = 0; c < GROUP; c++) {
    if (c < ncols) {
      const fp::F s = warp_sum(acc[c]);
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < 8; w++) red[warp][c][w] = s.v[w];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < ncols) {
    fp::F s;
#pragma unroll
    for (int w = 0; w < 8; w++) s.v[w] = red[0][threadIdx.x][w];
    for (int v = 1; v < WARPS; v++) {
      fp::F a;
#pragma unroll
      for (int w = 0; w < 8; w++) a.v[w] = red[v][threadIdx.x][w];
      s = fp::add(s, a);
    }
    fp::store(partial + (((long long)grp * nranges + range) * GROUP
                         + threadIdx.x) * 8, s);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counters + grp, 1) == nranges - 1;
  __syncthreads();
  if (!last) return;

  // every block of the group has stored its partials: sum them
  __threadfence();
  if (warp < ncols) {
    fp::F s = fp::zero();
    for (int r = lane; r < nranges; r += 32)
      s = fp::add(s, load_cg(partial + (((long long)grp * nranges + r) * GROUP
                                        + warp) * 8));
    s = warp_sum(s);
    if (lane == 0) fp::store(out + (long long)row[2 + GROUP + warp] * 8, s);
  }
  if (threadIdx.x == 0) counters[grp] = 0;
}

}  // namespace

extern "C" int open_pairs(const void* cols, long long n, const void* lo,
                          int logb, const void* hi, const void* groups,
                          int ngroups, int nranges, long long chunk,
                          void* partial, void* counters, void* out,
                          void* stream) {
  if (nranges < 1 || nranges > 65535 || chunk < 1 ||
      (long long)nranges * chunk < n)
    return (int)cudaErrorInvalidValue;
  if (ngroups > 0) {
    dim3 grid((unsigned)ngroups, (unsigned)nranges);
    open_pairs_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)cols, n, (const uint32_t*)lo, logb,
        (const uint32_t*)hi, (const int*)groups, chunk, (uint32_t*)partial,
        (int*)counters, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
