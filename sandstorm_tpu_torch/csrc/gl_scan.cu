// Kernels gl_scan_mul and gl_batch_inv: the Goldilocks (L = 2) and GF(p^3)
// (L = 6) running product along axis 0 and the segmented Montgomery batch
// inversion built on it, one template on the element for both fields.
//
// Replaces the scans under the JAX package's GL.batch_inv and GL3.batch_inv
// (sandstorm_tpu/fields/goldilocks.py:239, gl3.py:349):
// sandstorm_tpu/fields/scan.py:57 _prefix_mul_2level and :88 prefix_mul.
// Those are XLA, not Pallas: a TPU scan is a log-depth sequence of
// full-array passes, and the port's plain version (fields/scan.py
// prefix_scan) is log2 n Hillis-Steele stages, a multiply and a copy each.
//
// The design is csrc/scan.cu's (the Fp252 pair), with the element a u64 or
// three: gl_scan_mul is ONE launch, a chained scan with decoupled look-back
// (a block takes the next tile id from an atomic counter, so every tile it
// waits for belongs to a block that is already running; a tile is THREADS
// runs of `run` rows): each thread multiplies its run, the block scans the
// run products and publishes the tile's aggregate, looks back over its
// predecessors' aggregates and inclusive prefixes until it meets an
// inclusive one, publishes its inclusive prefix, and each thread walks its
// run again from its exclusive prefix.  gl_batch_inv inverts every column
// of several arrays (segments) in two launches and one host trip: the
// forward launch writes each row's product of the rows before it within
// its run (pre) into `out`, each run's product G and global exclusive
// prefix F, and each column's total; the host inverts the totals (a zero
// stays zero: fields/gl_cuda.py invert_totals, the field's own inverse);
// the backward launch starts each run at inv(G) = total^-1 F (the rows
// after the run), through the same look-back in reverse tile order, and
// walks the run from its end: out[i] = acc pre[i], acc *= a[i].  A zero in
// a column zeroes that column's seed, so every inverse of that column and
// of no other is zero, as in the JAX package.
//
// Bound on the H100: device memory.  A GL multiply is 8 IMAD-pipe issues
// (four 32 x 32 products, lo and hi), a GF(p^3) multiply 9 of them (72);
// a scan row moves 2 x 8 (24) bytes, so the bytes bound the scan in both
// fields, and the batch inversion (a read twice, pre written and read,
// out written) too.  What this first version leaves: the stores are a row
// a thread (run rows apart within a warp; csrc/scan.cu stages them in
// shared memory for whole spans), and the look-back's serial products.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;    // SCAN_THREADS in fields/fp252_cuda.py
constexpr int MIN_BLOCKS = 2;   // SCAN_BLOCKS_PER_SM: run_length's tiles
constexpr int WARPS = THREADS / 32;
constexpr unsigned AGGREGATE = 1, INCLUSIVE = 2;

// The look-back state of one launch, status_words(tiles, W) words
// (status_words in fields/fp252_cuda.py), zeroed before the launch: the
// tile counter, one flag a tile (0 nothing yet, AGGREGATE, INCLUSIVE), then
// the aggregates and the inclusive prefixes, W words a tile each.  The
// writer stores the value, fences, then sets the flag with a release
// store; the reader polls the flags with relaxed loads, fences once they
// are all set, then loads the values from L2.  Aggregate and inclusive
// prefix have slots of their own.
struct Status {
  unsigned* counter;
  unsigned* flags;
  uint32_t* agg;
  uint32_t* inc;
};

__host__ __device__ __forceinline__ long long status_words(long long tiles,
                                                           int W) {
  return 8 + (tiles + 7) / 8 * 8 + 2 * W * tiles;
}

__device__ __forceinline__ Status status_at(uint32_t* base, long long tiles,
                                            int W) {
  const long long f = (tiles + 7) / 8 * 8;
  return {base, base + 8, base + 8 + f, base + 8 + f + W * tiles};
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

template <class Fd>
__device__ __forceinline__ void publish(uint32_t* vals, unsigned* flags,
                                        long long id,
                                        const typename Fd::E& v,
                                        unsigned flag) {
  Fd::store(vals + id * Fd::W, v);
  __threadfence();
  st_release(flags + id, flag);
}

// Shared state of a block.
template <class Fd>
struct Shared {
  typename Fd::E warp[WARPS];   // block_scan's and block_product's values
  typename Fd::E all[THREADS];  // the block scan's inclusive products
  typename Fd::E product;       // block_product's result
  long long id;                 // the tile
  int stop;                     // look_back's nearest inclusive prefix
};

// inclusive product of v over the block's threads in thread order; the
// block's threads all call it (it synchronises)
template <class Fd>
__device__ typename Fd::E block_scan(typename Fd::E v, Shared<Fd>& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const typename Fd::E o = Fd::shfl_up(v, d);
    if (lane >= d) v = Fd::mul(o, v);
  }
  if (lane == 31) sh.warp[w] = v;
  __syncthreads();
  if (w == 0) {
    typename Fd::E t = lane < WARPS ? sh.warp[lane] : Fd::one();
#pragma unroll 1
    for (int d = 1; d < WARPS; d <<= 1) {
      const typename Fd::E o = Fd::shfl_up(t, d);
      if (lane >= d) t = Fd::mul(o, t);
    }
    if (lane < WARPS) sh.warp[lane] = t;
  }
  __syncthreads();
  if (w > 0) v = Fd::mul(sh.warp[w - 1], v);
  return v;
}

// the product of v over the block's threads, in every thread
template <class Fd>
__device__ typename Fd::E block_product(typename Fd::E v, Shared<Fd>& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll 1
  for (int m = 1; m < 32; m <<= 1) v = Fd::mul(v, Fd::shfl_xor(v, m));
  if (lane == 0) sh.warp[w] = v;
  __syncthreads();
  if (w == 0) {
    typename Fd::E t = lane < WARPS ? sh.warp[lane] : Fd::one();
#pragma unroll 1
    for (int m = 1; m < WARPS; m <<= 1) t = Fd::mul(t, Fd::shfl_xor(t, m));
    if (lane == 0) sh.product = t;
  }
  __syncthreads();
  return sh.product;
}

// all threads: the product of tile `id`'s predecessors in its column (ids
// id - 1 ... id - depth, depth >= 1; the farthest publishes only an
// inclusive prefix), THREADS tiles a step, one a thread, stopping at the
// nearest inclusive prefix
template <class Fd>
__device__ typename Fd::E look_back(const Status& st, long long id,
                                    long long depth, Shared<Fd>& sh) {
  typename Fd::E acc = Fd::one();
#pragma unroll 1
  for (long long d0 = 0;; d0 += THREADS) {
    const long long d = d0 + threadIdx.x, j = id - 1 - d;
    unsigned f = 0;
    if (threadIdx.x == 0) sh.stop = THREADS;
    if (d < depth)
      while ((f = ld_relaxed(st.flags + j)) == 0) {
      }
    __threadfence();
    __syncthreads();
    if (f == INCLUSIVE) atomicMin(&sh.stop, (int)threadIdx.x);
    __syncthreads();
    const int stop = sh.stop;
    typename Fd::E v = Fd::one();
    if (d < depth && (int)threadIdx.x <= stop)
      v = Fd::load_cg((f == INCLUSIVE ? st.inc : st.agg) + j * Fd::W);
    acc = Fd::mul(acc, block_product(v, sh));
    if (stop < THREADS) return acc;
  }
}

// all threads: the tile's exclusive prefix, `first` for the first tile of
// its column (depth 0), else the look-back's product; thread 0 publishes
// the aggregate A before looking back and the inclusive prefix after
template <class Fd>
__device__ typename Fd::E tile_prefix(const Status& st, long long id,
                                      long long depth,
                                      const typename Fd::E& A,
                                      const typename Fd::E& first,
                                      Shared<Fd>& sh) {
  typename Fd::E x = first;
  if (depth > 0) {
    if (threadIdx.x == 0) publish<Fd>(st.agg, st.flags, id, A, AGGREGATE);
    x = look_back(st, id, depth, sh);
  }
  if (threadIdx.x == 0)
    publish<Fd>(st.inc, st.flags, id, Fd::mul(x, A), INCLUSIVE);
  return x;
}

template <class Fd>
__device__ __forceinline__ long long take_tile(unsigned* counter,
                                               Shared<Fd>& sh) {
  if (threadIdx.x == 0) sh.id = atomicAdd(counter, 1u);
  __syncthreads();
  return sh.id;
}

__device__ __forceinline__ int run_rows(long long end, long long first,
                                        int run) {
  const long long r = end - first;
  return r <= 0 ? 0 : (r < run ? (int)r : run);
}

// -- gl_scan_mul -------------------------------------------------------------

// x, out: [n, C, W] words; logical row i is physical row i, or n - 1 - i
// in reverse
template <class Fd>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
scan_kernel(const uint32_t* __restrict__ x, long long n, int C, int reverse,
            int run, long long per_col, uint32_t* status,
            uint32_t* __restrict__ out) {
  using E = typename Fd::E;
  __shared__ Shared<Fd> sh;
  const Status st = status_at(status, per_col * C, Fd::W);
  const long long id = take_tile(st.counter, sh);
  const long long c = id / per_col, k = id % per_col;
  const long long first = k * THREADS * run + (long long)threadIdx.x * run;
  const int rows = run_rows(n, first, run);
  const long long step = reverse ? -(long long)Fd::W * C
                                 : (long long)Fd::W * C;
  const long long at0 =
      rows ? ((reverse ? n - 1 - first : first) * C + c) * Fd::W : 0;
  const uint32_t* xp = x + at0;
  // 1. this thread's run product
  E g = Fd::one(), next = rows ? Fd::load(xp) : Fd::one();
#pragma unroll 1
  for (int r = 0; r < rows; r++) {
    const E v = next;
    if (r + 1 < rows) next = Fd::load(xp + (r + 1) * step);
    g = r ? Fd::mul(g, v) : v;
  }
  // 2-3. the block's scan of the run products, the tile's prefix
  sh.all[threadIdx.x] = block_scan(g, sh);
  __syncthreads();
  E acc = tile_prefix(st, id, k, sh.all[THREADS - 1], Fd::one(), sh);
  if (threadIdx.x > 0) acc = Fd::mul(acc, sh.all[threadIdx.x - 1]);
  // 4. the run again (from L2), every row written
  uint32_t* op = out + at0;
  if (rows) next = Fd::load(xp);
#pragma unroll 1
  for (int r = 0; r < rows; r++) {
    const E v = next;
    if (r + 1 < rows) next = Fd::load(xp + (r + 1) * step);
    acc = Fd::mul(acc, v);
    Fd::store(op + r * step, acc);
  }
}

// -- gl_batch_inv ------------------------------------------------------------

// a segment: [in, out, n, C, first column's index in totals / seeds]; a
// tile: [segment, column, first row, rows, index k in its column, tiles K
// of its column] (inv_tables in fields/fp252_cuda.py), its runs at
// runs[(tile * THREADS + run) * 2W]: F (W words), then G
constexpr int SEG = 5, TILE_ROW = 6;

template <class Fd>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inv_forward_kernel(const long long* __restrict__ segs,
                   const long long* __restrict__ tiles, long long ntiles,
                   int run, uint32_t* status, uint32_t* __restrict__ runs,
                   uint32_t* __restrict__ totals) {
  using E = typename Fd::E;
  __shared__ Shared<Fd> sh;
  const Status st = status_at(status, ntiles, Fd::W);
  const long long id = take_tile(st.counter, sh);
  const long long* T = tiles + id * TILE_ROW;
  const long long* S = segs + T[0] * SEG;
  const long long c = T[1], C = S[3];
  const long long first = T[2] + (long long)threadIdx.x * run;
  const int rows = run_rows(T[2] + T[3], first, run);
  const long long step = (long long)Fd::W * C;
  const long long at0 = rows ? (first * C + c) * Fd::W : 0;
  const uint32_t* xp = reinterpret_cast<const uint32_t*>(S[0]) + at0;
  uint32_t* op = reinterpret_cast<uint32_t*>(S[1]) + at0;
  // pre[i], the product of the run's rows before row i, into out
  E g = Fd::one(), next = rows ? Fd::load(xp) : Fd::one();
#pragma unroll 1
  for (int r = 0; r < rows; r++) {
    const E v = next;
    if (r + 1 < rows) next = Fd::load(xp + (r + 1) * step);
    Fd::store(op + r * step, g);
    g = r ? Fd::mul(g, v) : v;
  }
  sh.all[threadIdx.x] = block_scan(g, sh);
  __syncthreads();
  const E A = sh.all[THREADS - 1];
  const E X = tile_prefix(st, id, T[4], A, Fd::one(), sh);
  if (rows > 0) {
    uint32_t* rp = runs + (id * THREADS + threadIdx.x) * 2 * Fd::W;
    Fd::store(rp, threadIdx.x ? Fd::mul(X, sh.all[threadIdx.x - 1]) : X);
    Fd::store(rp + Fd::W, g);
  }
  if (threadIdx.x == 0 && T[4] == T[5] - 1)
    Fd::store(totals + (S[4] + c) * Fd::W, Fd::mul(X, A));
}

// tiles in reverse order: backward tile id b takes tile ntiles - 1 - b, so
// a column's tiles come from its last to its first, with consecutive ids;
// thread t takes the tile's run THREADS - 1 - t
template <class Fd>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inv_backward_kernel(const long long* __restrict__ segs,
                    const long long* __restrict__ tiles, long long ntiles,
                    int run, uint32_t* status,
                    const uint32_t* __restrict__ runs,
                    const uint32_t* __restrict__ seeds) {
  using E = typename Fd::E;
  __shared__ Shared<Fd> sh;
  const Status st = status_at(status, ntiles, Fd::W);
  const long long id = take_tile(st.counter, sh);
  const long long tile = ntiles - 1 - id;
  const long long* T = tiles + tile * TILE_ROW;
  const long long* S = segs + T[0] * SEG;
  const long long c = T[1], C = S[3];
  const int mine = THREADS - 1 - threadIdx.x;
  const long long first = T[2] + (long long)mine * run;
  const int rows = run_rows(T[2] + T[3], first, run);
  E f = Fd::one(), g = Fd::one();
  if (rows > 0) {
    const uint32_t* rp = runs + (tile * THREADS + mine) * 2 * Fd::W;
    f = Fd::load(rp);
    g = Fd::load(rp + Fd::W);
  }
  sh.all[threadIdx.x] = block_scan(g, sh);
  __syncthreads();
  // the tile's exclusive suffix product, times total^-1
  const E Y = tile_prefix(st, id, T[5] - 1 - T[4], sh.all[THREADS - 1],
                          Fd::load(seeds + (S[4] + c) * Fd::W), sh);
  E acc = threadIdx.x ? Fd::mul(Y, sh.all[threadIdx.x - 1]) : Y;
  acc = Fd::mul(acc, f);   // inv(G) for this run
  // row r from the run's end: out = acc * pre, then acc *= a (pre read
  // from the row before it is written)
  const long long at0 = rows ? (first * C + c) * Fd::W : 0;
  const long long step = (long long)Fd::W * C;
  uint32_t* op = reinterpret_cast<uint32_t*>(S[1]) + at0;
  const uint32_t* xp = reinterpret_cast<const uint32_t*>(S[0]) + at0;
  E pre = Fd::one(), a = Fd::one();
  if (rows) {
    pre = Fd::load(op + (rows - 1) * step);
    a = Fd::load(xp + (rows - 1) * step);
  }
#pragma unroll 1
  for (int r = rows - 1; r >= 0; r--) {
    const E p = pre, v = a;
    if (r) {
      pre = Fd::load(op + (r - 1) * step);
      a = Fd::load(xp + (r - 1) * step);
    }
    Fd::store(op + r * step, Fd::mul(acc, p));
    if (r) acc = Fd::mul(acc, v);
  }
}

template <class Fd>
int scan_launch(const void* x, long long n, int C, int reverse, int run,
                void* out, void* status, cudaStream_t s) {
  const long long per_col = (n + (long long)THREADS * run - 1) /
                            ((long long)THREADS * run);
  const long long tiles = per_col * C;
  const cudaError_t e =
      cudaMemsetAsync(status, 0, status_words(tiles, Fd::W) * 4, s);
  if (e != cudaSuccess) return (int)e;
  scan_kernel<Fd><<<(unsigned)tiles, THREADS, 0, s>>>(
      (const uint32_t*)x, n, C, reverse, run, per_col, (uint32_t*)status,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

template <class Fd>
int inv_launch(const long long* segs, long long nsegs, long long ntiles,
               int run, int phase, uint32_t* st, void* runs, void* values,
               cudaStream_t s) {
  const long long* tiles = segs + nsegs * SEG;
  const long long words = status_words(ntiles, Fd::W);
  if (phase == 0) {
    const cudaError_t e = cudaMemsetAsync(st, 0, 2 * words * 4, s);
    if (e != cudaSuccess) return (int)e;
    inv_forward_kernel<Fd><<<(unsigned)ntiles, THREADS, 0, s>>>(
        segs, tiles, ntiles, run, st, (uint32_t*)runs, (uint32_t*)values);
  } else {
    inv_backward_kernel<Fd><<<(unsigned)ntiles, THREADS, 0, s>>>(
        segs, tiles, ntiles, run, st + words, (const uint32_t*)runs,
        (const uint32_t*)values);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [n, C, L] words (L = 2: GL, 6: GF(p^3)), not overlapping; status:
// status_words(tiles, L) words, tiles = C * ceil(n / (THREADS * run))
extern "C" int gl_scan_mul(const void* x, long long n, int C, int reverse,
                           int run, int L, void* out, void* status,
                           void* stream) {
  if (L != 2 && L != 6) return (int)cudaErrorInvalidValue;
  if (n > 0 && C > 0 && run > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    return L == 2 ? scan_launch<GLF>(x, n, C, reverse, run, out, status, s)
                  : scan_launch<GL3F>(x, n, C, reverse, run, out, status, s);
  }
  return (int)cudaGetLastError();
}

// meta: the segment rows, then the tile rows (int64); status: two
// status_words(ntiles, L) areas (forward, backward); runs: ntiles *
// THREADS * 2L words; phase 0 zeroes both areas and runs the forward
// launch, writing each column's total into `values`; phase 1 runs the
// backward launch, reading each column's inverse total from it
extern "C" int gl_batch_inv(const void* meta, long long nsegs,
                            long long ntiles, int run, int phase, int L,
                            void* status, void* runs, void* values,
                            void* stream) {
  if (L != 2 && L != 6) return (int)cudaErrorInvalidValue;
  if (ntiles > 0 && run > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long* segs = (const long long*)meta;
    uint32_t* st = (uint32_t*)status;
    return L == 2 ? inv_launch<GLF>(segs, nsegs, ntiles, run, phase, st, runs,
                                    values, s)
                  : inv_launch<GL3F>(segs, nsegs, ntiles, run, phase, st,
                                     runs, values, s);
  }
  return (int)cudaGetLastError();
}
