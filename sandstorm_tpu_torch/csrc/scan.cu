// Kernel fp252_scan_mul: the inclusive running product along axis 0 of an
// [n, C, 8] Fp252 array (C independent columns), forward or in reverse.
//
// Replaces the scans under the JAX package's Fp252.batch_inv:
// sandstorm_tpu/fields/scan.py:56 _prefix_mul_2level (a Hillis-Steele pass
// along sqrt(n)-row tiles, a small prefix over the tile totals, one
// broadcast multiply) and :88 prefix_mul.  Those are XLA, not Pallas: a TPU
// scan is a log-depth sequence of full-array passes.  Here a block scans
// its own tile in registers and shared memory, so the whole scan is three
// launches whatever n is.
//
// Bound on the H100: device memory.  The product needs n - 1 montmuls a
// column (128 IMAD issues each) against 64 bytes an element (read once,
// written once): at 3.35 TB/s and ~15 Tops/s the bytes take about 1.6x as
// long.  The design spends about 3 montmuls an element, and reads each
// element twice (the second time from L2), to keep every pass a full-width
// one:
//   1. totals: each thread multiplies its run of RUN rows, the block
//      combines its THREADS run products (warp shuffles, then one warp over
//      the warp totals) and writes the tile's total;
//   2. carry: one block a column scans the tile totals, in chunks of
//      THREADS with a running carry, into exclusive tile prefixes;
//   3. apply: each thread forms its run product again, the block scans
//      them, and the thread walks its run from its exclusive prefix (tile
//      prefix times the runs before it), writing every row.
// Reverse maps logical row i to row n - 1 - i in both arrays.
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

constexpr int THREADS = 256;   // SCAN_THREADS in fields/fp252_cuda.py
constexpr int RUN = 16;        // rows a thread takes (SCAN_RUN)
constexpr int TILE = THREADS * RUN;
constexpr int WARPS = THREADS / 32;

// the Montgomery form of 1: 2^256 mod p
__device__ __forceinline__ fp::F one() {
  fp::F r;
  r.v[0] = 0xffffffe1u; r.v[1] = 0xffffffffu; r.v[2] = 0xffffffffu;
  r.v[3] = 0xffffffffu; r.v[4] = 0xffffffffu; r.v[5] = 0xffffffffu;
  r.v[6] = 0xfffffdf0u; r.v[7] = 0x07ffffffu;
  return r;
}

__device__ __forceinline__ long long phys(long long i, long long n,
                                          int reverse) {
  return reverse ? n - 1 - i : i;
}

// inclusive product of v over the block's threads in thread order; the
// block's threads all call it (it synchronises)
__device__ fp::F block_scan(fp::F v, fp::F* s_warp) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    fp::F o;
#pragma unroll
    for (int k = 0; k < 8; k++) o.v[k] = __shfl_up_sync(0xffffffffu, v.v[k], d);
    if (lane >= d) v = fp::mul(o, v);
  }
  if (lane == 31) s_warp[w] = v;
  __syncthreads();
  if (w == 0) {
    fp::F t = lane < WARPS ? s_warp[lane] : one();
#pragma unroll 1
    for (int d = 1; d < WARPS; d <<= 1) {
      fp::F o;
#pragma unroll
      for (int k = 0; k < 8; k++)
        o.v[k] = __shfl_up_sync(0xffffffffu, t.v[k], d);
      if (lane >= d) t = fp::mul(o, t);
    }
    if (lane < WARPS) s_warp[lane] = t;
  }
  __syncthreads();
  if (w > 0) v = fp::mul(s_warp[w - 1], v);
  return v;
}

// the product of this thread's run of rows of column c (1 past the end)
__device__ fp::F run_product(const uint32_t* __restrict__ x, long long n,
                             int C, int c, int reverse, long long first) {
  fp::F acc = one();
  bool any = false;
#pragma unroll 1
  for (int r = 0; r < RUN; r++) {
    const long long i = first + r;
    if (i >= n) break;
    const fp::F v = fp::load(x + (phys(i, n, reverse) * C + c) * 8);
    acc = any ? fp::mul(acc, v) : v;
    any = true;
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
totals_kernel(const uint32_t* __restrict__ x, long long n, int C, int reverse,
              uint32_t* __restrict__ totals) {
  __shared__ fp::F s_warp[WARPS];
  const int c = blockIdx.y;
  const long long first = (long long)blockIdx.x * TILE + threadIdx.x * RUN;
  const fp::F t = block_scan(run_product(x, n, C, c, reverse, first), s_warp);
  if (threadIdx.x == THREADS - 1)
    fp::store(totals + ((long long)blockIdx.x * C + c) * 8, t);
}

// tile totals [nb, C] -> exclusive tile prefixes, in place
__global__ void __launch_bounds__(THREADS)
carry_kernel(uint32_t* __restrict__ totals, long long nb, int C) {
  __shared__ fp::F s_warp[WARPS];
  __shared__ fp::F s_all[THREADS];
  const int c = blockIdx.x;
  fp::F carry = one();
#pragma unroll 1
  for (long long b0 = 0; b0 < nb; b0 += THREADS) {
    const long long b = b0 + threadIdx.x;
    const fp::F v = b < nb ? fp::load(totals + (b * C + c) * 8) : one();
    s_all[threadIdx.x] = block_scan(v, s_warp);
    __syncthreads();
    const fp::F excl =
        threadIdx.x == 0 ? carry : fp::mul(carry, s_all[threadIdx.x - 1]);
    if (b < nb) fp::store(totals + (b * C + c) * 8, excl);
    carry = fp::mul(carry, s_all[THREADS - 1]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
apply_kernel(const uint32_t* __restrict__ x, long long n, int C, int reverse,
             const uint32_t* __restrict__ prefixes, uint32_t* __restrict__ out) {
  __shared__ fp::F s_warp[WARPS];
  __shared__ fp::F s_all[THREADS];
  const int c = blockIdx.y;
  const long long first = (long long)blockIdx.x * TILE + threadIdx.x * RUN;
  s_all[threadIdx.x] =
      block_scan(run_product(x, n, C, c, reverse, first), s_warp);
  __syncthreads();
  fp::F acc = fp::load(prefixes + ((long long)blockIdx.x * C + c) * 8);
  if (threadIdx.x > 0) acc = fp::mul(acc, s_all[threadIdx.x - 1]);
#pragma unroll 1
  for (int r = 0; r < RUN; r++) {
    const long long i = first + r;
    if (i >= n) break;
    const long long at = (phys(i, n, reverse) * C + c) * 8;
    acc = fp::mul(acc, fp::load(x + at));
    fp::store(out + at, acc);
  }
}

}  // namespace

// x, out: [n, C, 8] words, not overlapping; scratch: [ceil(n / TILE), C, 8]
// words
extern "C" int fp252_scan_mul(const void* x, long long n, int C, int reverse,
                              void* out, void* scratch, void* stream) {
  if (n > 0 && C > 0) {
    const long long nb = (n + TILE - 1) / TILE;
    cudaStream_t s = (cudaStream_t)stream;
    dim3 grid((unsigned)nb, (unsigned)C);
    totals_kernel<<<grid, THREADS, 0, s>>>((const uint32_t*)x, n, C, reverse,
                                           (uint32_t*)scratch);
    carry_kernel<<<C, THREADS, 0, s>>>((uint32_t*)scratch, nb, C);
    apply_kernel<<<grid, THREADS, 0, s>>>((const uint32_t*)x, n, C, reverse,
                                          (const uint32_t*)scratch,
                                          (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
