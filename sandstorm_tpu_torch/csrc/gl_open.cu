// Kernel gl_open_pairs: the pair-indexed OODS opener over Goldilocks (L = 2)
// and GF(p^3) (L = 6).  For each requested (point k, column c) pair,
//     out[p] = sum_i cols[c][i] pt_k^i,   pt_k^i = hi[k][i >> log2 b]
//                                                  lo[k][i & (b - 1)],
// one template on the element (goldilocks.cuh GLF / GL3F).
//
// Replaces the JAX package's dense opener of the non-fp252 fields,
// sandstorm_tpu/stark/openings.py:32 _open_all_at_point (a dispatch a
// point, every column at every point), whose power tables :20
// _point_power_stack builds with prefix_mul (here gl_scan_mul,
// csrc/gl_scan.cu).  It opens only the pairs a prove asks for (the plain
// layout over GF(p^3): 50 of the dense 160 values at 20 points).
//
// Layout: the columns are a list of pointers with row strides in words
// (the prover's coefficient columns are views of its [n, C, L] transforms;
// no stack), lo [K, b, L], hi [K, n / b, L].  The wrapper
// (stark/openings.py:open_pairs_gl, with fields/fp252_cuda.py:pair_groups)
// sorts the pairs into groups: one point and up to GROUP of its columns.
// groups is [ngroups, 2 + 2 GROUP] int32: the point k, the number of
// columns, their indices, and the position of each pair in the caller's
// list.  partial is [ngroups, nranges, GROUP, L] scratch, counters
// [ngroups] zeros (left zero), out [P, L].
//
// Bound on the H100: the IMAD pipe.  A coefficient costs one GF(p^3)
// product for its point's power and, a column, three Goldilocks products
// (a base column: the wrapper names the first nbase columns, whose upper
// coordinates are zero, and the kernel reads their c0 word alone) or an
// extension product.  Design (that of csrc/open_pairs.cu, the Fp252
// opener):
//  - a block is (group, range of i): a thread forms pt^i = hi * lo once per
//    i and multiplies it into each of its group's columns, so a point's
//    power is formed once a coefficient, not once a column group;
//  - each column's sum is kept unreduced over the thread's coefficients
//    (gl::Wide, a 128-bit sum and a carry word a coordinate) and reduced
//    once, then summed over the block (warp shuffles, the warps' sums in
//    shared memory);
//  - one launch: the last block of a group to finish (a device counter
//    behind __threadfence) sums the group's partials in index order and
//    writes the pairs' values.  Field addition is exact: no order of the
//    sums changes a value.
//  The groups are the fast index of the grid, so the groups that name a
//  column read it while it is in L2.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;   // fields/fp252_cuda OPEN_THREADS
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 4;       // columns a block: fields/fp252_cuda OPEN_GROUP
constexpr int MAXC = 32;       // columns a call (GL_OPEN_MAX_COLUMNS)
constexpr int MIN_BLOCKS = 2;  // blocks an SM: registers capped at 128
constexpr int ROW = 2 + 2 * GROUP;
static_assert(WARPS >= GROUP, "the final sum takes a warp per column");

struct Cols {
  const uint32_t* p[MAXC];
  long long st[MAXC];   // row stride, in u32 words
};

template <class Fd>
__device__ __forceinline__ typename Fd::E warp_sum(typename Fd::E a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a = Fd::add(a, Fd::shfl_down(a, off));
  return a;
}

template <class Fd>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gl_open_pairs_kernel(const __grid_constant__ Cols cols, int nbase,
                     long long n, const uint32_t* __restrict__ lo, int logb,
                     const uint32_t* __restrict__ hi,
                     const int* __restrict__ groups, long long chunk,
                     uint32_t* partial, int* counters,
                     uint32_t* __restrict__ out) {
  using E = typename Fd::E;
  __shared__ E red[WARPS][GROUP];
  __shared__ int last;
  const int grp = blockIdx.x, range = blockIdx.y, nranges = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* row = groups + (long long)grp * ROW;
  const int k = row[0], ncols = row[1];
  const long long b = 1LL << logb;
  const uint32_t* lok = lo + (long long)k * b * Fd::W;
  const uint32_t* hik = hi + (long long)k * (n >> logb) * Fd::W;
  const uint32_t* cp[GROUP];
  long long cs[GROUP];
  bool base[GROUP];
#pragma unroll
  for (int q = 0; q < GROUP; q++) {
    const int c = row[2 + (q < ncols ? q : 0)];
    cp[q] = cols.p[c];
    cs[q] = cols.st[c];
    base[q] = c < nbase;
  }
  const long long start = (long long)range * chunk;
  const long long end = start + chunk < n ? start + chunk : n;

  typename Fd::A acc[GROUP];
#pragma unroll
  for (int q = 0; q < GROUP; q++) acc[q] = Fd::a_zero();
#pragma unroll 1
  for (long long i = start + threadIdx.x; i < end; i += THREADS) {
    const typename Fd::D z = Fd::prep(
        Fd::mul(Fd::load(hik + (i >> logb) * Fd::W),
                Fd::load(lok + (i & (b - 1)) * Fd::W)));
#pragma unroll
    for (int q = 0; q < GROUP; q++) {
      if (q < ncols) {
        const uint32_t* x = cp[q] + i * cs[q];
        if (base[q])
          Fd::mac_base(acc[q], z, gl::load(x));
        else
          Fd::mac(acc[q], Fd::load(x), z);
      }
    }
  }

  // the block's sum a column: each thread's sum reduced once, then the
  // lanes, then the warps in index order
#pragma unroll
  for (int q = 0; q < GROUP; q++) {
    if (q < ncols) {
      const E s = warp_sum<Fd>(Fd::reduce(acc[q]));
      if (lane == 0) red[warp][q] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < ncols) {
    E s = red[0][threadIdx.x];
#pragma unroll 1
    for (int v = 1; v < WARPS; v++) s = Fd::add(s, red[v][threadIdx.x]);
    Fd::store(partial + (((long long)grp * nranges + range) * GROUP
                         + threadIdx.x) * Fd::W, s);
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
    E s = Fd::zero();
#pragma unroll 1
    for (int r = lane; r < nranges; r += 32)
      s = Fd::add(s, Fd::load_cg(partial + (((long long)grp * nranges + r)
                                            * GROUP + warp) * Fd::W));
    s = warp_sum<Fd>(s);
    if (lane == 0)
      Fd::store(out + (long long)row[2 + GROUP + warp] * Fd::W, s);
  }
  if (threadIdx.x == 0) counters[grp] = 0;
}

}  // namespace

// ptrs / strides: C host int64s (C <= MAXC), the first nbase columns base
// (c0 read alone); lo [K, 2^logb, L], hi [K, n >> logb, L] words (L = 2:
// GL, 6: GF(p^3)); groups [ngroups, 2 + 2 GROUP] int32; partial
// [ngroups, nranges, GROUP, L], counters [ngroups] zeros; out [P, L]
extern "C" int gl_open_pairs(const long long* ptrs, const long long* strides,
                             int C, int nbase, long long n, const void* lo,
                             int logb, const void* hi, const void* groups,
                             int ngroups, int nranges, long long chunk, int L,
                             void* partial, void* counters, void* out,
                             void* stream) {
  if ((L != 2 && L != 6) || C < 1 || C > MAXC || nbase < 0 || nbase > C ||
      nranges < 1 || nranges > 65535 || chunk < 1 ||
      (long long)nranges * chunk < n)
    return (int)cudaErrorInvalidValue;
  Cols cols;
  for (int c = 0; c < MAXC; c++) {
    cols.p[c] = c < C ? (const uint32_t*)ptrs[c] : nullptr;
    cols.st[c] = c < C ? strides[c] : 0;
  }
  if (ngroups > 0) {
    dim3 grid((unsigned)ngroups, (unsigned)nranges);
    cudaStream_t s = (cudaStream_t)stream;
    if (L == 2)
      gl_open_pairs_kernel<GLF><<<grid, THREADS, 0, s>>>(
          cols, nbase, n, (const uint32_t*)lo, logb, (const uint32_t*)hi,
          (const int*)groups, chunk, (uint32_t*)partial, (int*)counters,
          (uint32_t*)out);
    else
      gl_open_pairs_kernel<GL3F><<<grid, THREADS, 0, s>>>(
          cols, nbase, n, (const uint32_t*)lo, logb, (const uint32_t*)hi,
          (const int*)groups, chunk, (uint32_t*)partial, (int*)counters,
          (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
