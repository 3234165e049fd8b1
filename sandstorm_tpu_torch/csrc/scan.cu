// Kernels fp252_scan_mul, fp252_batch_inv and fp252_affine_scan: the Fp252
// running product along axis 0, the segmented Montgomery batch inversion
// built on it, and the scan of affine maps.
//
// Replaces the scans under the JAX package's Fp252.batch_inv
// (sandstorm_tpu/fields/fp252.py:534): sandstorm_tpu/fields/scan.py:56
// _prefix_mul_2level and :88 prefix_mul.  Those are XLA, not Pallas: a TPU
// scan is a log-depth sequence of full-array passes.
//
// fp252_scan_mul: the inclusive running product along axis 0 of an
// [n, C, 8] array (C independent columns), forward or in reverse, in ONE
// launch: a chained scan with decoupled look-back.  A block takes the next
// tile id from an atomic counter (so every tile it waits for belongs to a
// block that is already running), tiles of a column have consecutive ids,
// and a tile is THREADS runs of `run` rows (run from n: 1 for a small
// call, up to 32 at 2^22 rows):
//   1. each thread multiplies its run (run - 1 montmuls);
//   2. the block scans the run products (warp shuffles, then one warp over
//      the warp totals) and publishes the tile's aggregate;
//   3. the block looks back over the predecessors' published aggregates
//      and inclusive prefixes, 256 tiles a step, until it meets an
//      inclusive one, and publishes the tile's inclusive prefix;
//   4. each thread walks its run again from its exclusive prefix (one
//      montmul a row), staging every row for the block's coalesced store.
// The second walk re-reads the run from L2 (mostly: at run 32 the tiles in
// flight, 2 blocks x 256 threads x 32 rows x 32 B an SM, exceed its 50 MB
// a little).  Every product is fp252.cuh's mul_wide_redc.
//
// What holds it back: the montmuls.  The two walks spend two products a
// row, and the card's montmul rate makes that longer than the row's bytes
// take; the block scan and the look-back are serial chains of products
// that each tile adds (PERF.md).
//
// fp252_affine_scan: the inclusive forward scan of the affine maps
// x -> x a_k + b_k of an [n, 8] pair of arrays under composition,
// (a1, b1) then (a2, b2) = (a1 a2, b1 a2 + b2), in ONE launch, a pair of
// 64 bytes the element; it writes the column the recursive and starknet
// layouts' diluted aggregate is: row 0 = 1, row k + 1 = a + b of the maps
// 0..k composed (the map applied to 1).  Replaces the XLA routine
// sandstorm_tpu/fields/scan.py:23 prefix_scan with the compose of
// sandstorm_tpu/layouts/recursive/trace.py:421-426 and
// layouts/starknet/trace.py:664-669 (in the jitted
// _build_extension_columns); the port ran log2 n Hillis-Steele stages of
// three field launches and two torch.cats (fields/scan.py's plain
// version, kept for CPU tensors).
// What bounds it: 96 bytes an element (7.5 us at 2^18 - 1 maps) and 3
// montmuls (6.5 us), against a scan's serial chains: a chained scan's
// tiles wait on each other's inclusive prefixes (the look-back took 0.053
// of the 0.093 ms the chained design spent at 2^18 - 1, PERF.md), and a
// second wave of tiles starts behind the first.  The design:
//   - tiles of AT = 256 runs of `run` rows, sized by the wrapper
//     (fields/fp252_cuda.py affine_plan) to at most one an SM and AT, so
//     every tile of a call is resident at once: one wave (2^18 - 1 maps:
//     128 tiles of runs of 8 on 132 SMs);
//   - each thread stages its own run in shared memory by 16-byte
//     cp.async copies (a 32-byte row is one sector), a commit group a
//     row, so its composition starts on the first row while the later
//     ones arrive (16 KB x run of dynamic shared memory a tile); the walk
//     reads the maps there, writes the column over a's rows, and the block
//     stores it in coalesced 16-byte pieces: device memory read once;
//   - the block's scan: warp shuffles, then one warp over the warp totals;
//     each tile publishes only its aggregate, before it waits on anything;
//   - a tile's prefix is the ordered product of ALL its predecessors'
//     aggregates in one block product, thread t polling tile t's flag
//     (farthest first, so thread order is scan order; warps past the tile
//     skip their butterflies): no tile waits on another's look-back, and
//     no inclusive prefix is published.  A call of more than AT tiles
//     takes AT predecessors a step;
//   - the prefix enters as a value, the earlier tiles' maps applied to 1:
//     a thread's start is that value through the earlier warps' and lanes'
//     maps (2 montmuls), then y = y a_k + b_k a row (1 montmul).
// Tile ids come from the atomic counter, so a tile waits only on tiles
// whose blocks already run; the look-back state is zeroed by a memset
// before the launch (1.1 us of device time).  The composition is not
// commutative: the block's products keep thread order (each butterfly
// step puts the lower half's value first, by selects).
//
// fp252_batch_inv: Montgomery batch inversion of every column of several
// arrays (segments: in, out, n, C) in two launches and one host trip.
// The forward launch writes into `out` the product of the rows before each
// row within its run (pre), each run's product G and its global exclusive
// prefix F (through the same look-back), and each column's total; the
// host inverts the totals (a zero stays zero); the backward launch starts
// each run at inv(G) = total^-1 * F * (the products after the run) -- a
// reverse scan of the runs' G seeded with total^-1, through the look-back
// in reverse tile order -- and walks the run from its end: out[i] = acc *
// pre[i], acc *= a[i].  Three montmuls an element (one forward, two
// backward); `a` read twice, pre written and read once in `out`, out
// written once.  A zero in a column zeroes that column's seed, so every
// inverse of that column and of no other is zero, as in the JAX package.
//
// Bound on the H100: the scan needs n - 1 montmuls a column (128 IMAD
// issues each) against 64 bytes an element: device memory bounds it, but
// the design spends ~2 montmuls an element, so mul_wide_redc's rate (about
// 64% of the IMAD pipe's) is what it runs at.  The batch inversion's least
// work, 3 montmuls an element, bounds it by operations.
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

constexpr int THREADS = 256;    // SCAN_THREADS in fields/fp252_cuda.py
constexpr int MIN_BLOCKS = 2;   // blocks an SM (registers capped at 128)
constexpr int WARPS = THREADS / 32;
constexpr unsigned AGGREGATE = 1, INCLUSIVE = 2;

// the Montgomery form of 1: 2^256 mod p
__device__ __forceinline__ fp::F one() {
  fp::F r;
  r.v[0] = 0xffffffe1u; r.v[1] = 0xffffffffu; r.v[2] = 0xffffffffu;
  r.v[3] = 0xffffffffu; r.v[4] = 0xffffffffu; r.v[5] = 0xffffffffu;
  r.v[6] = 0xfffffdf0u; r.v[7] = 0x07ffffffu;
  return r;
}

__device__ __forceinline__ fp::F mulw(const fp::F& a, const fp::F& b) {
  return fp::mul_wide_redc(a, b);
}

// The look-back state of one launch, in `status_words(tiles)` words
// (status_words in fields/fp252_cuda.py), zeroed before the launch:
// the tile counter, one flag a tile (0 nothing yet, AGGREGATE, INCLUSIVE),
// then the aggregates and the inclusive prefixes, 8 words a tile each.  A
// 32-byte value cannot be published atomically with its flag: the writer
// stores the value, fences, then sets the flag with a release store; the
// reader polls the flags with relaxed loads, all of a look-back step at
// once, fences once they are all set, then loads the values from L2 (.cg).
// Aggregate and inclusive prefix have slots of their own, so a reader that
// saw AGGREGATE never reads an inclusive prefix written after it.
struct Status {
  unsigned* counter;
  unsigned* flags;
  uint32_t* agg;
  uint32_t* inc;
};

__host__ __device__ __forceinline__ long long status_words(long long tiles) {
  return 8 + (tiles + 7) / 8 * 8 + 16 * tiles;
}

__device__ __forceinline__ Status status_at(uint32_t* base, long long tiles) {
  const long long f = (tiles + 7) / 8 * 8;
  return {base, base + 8, base + 8 + f, base + 8 + f + 8 * tiles};
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ fp::F load_cg(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 x = __ldcg(q), y = __ldcg(q + 1);
  fp::F r;
  r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  r.v[4] = y.x; r.v[5] = y.y; r.v[6] = y.z; r.v[7] = y.w;
  return r;
}

__device__ __forceinline__ void publish(uint32_t* vals, unsigned* flags,
                                        long long id, const fp::F& v,
                                        unsigned flag) {
  fp::store(vals + id * 8, v);
  __threadfence();
  st_release(flags + id, flag);
}

__device__ __forceinline__ fp::F shfl(const fp::F& v, int src, bool up) {
  fp::F o;
#pragma unroll
  for (int k = 0; k < 8; k++)
    o.v[k] = up ? __shfl_up_sync(0xffffffffu, v.v[k], src)
                : __shfl_xor_sync(0xffffffffu, v.v[k], src);
  return o;
}

// the product of v over the warp's 32 lanes, in every lane
__device__ fp::F warp_product(fp::F v) {
#pragma unroll 1
  for (int m = 1; m < 32; m <<= 1) v = mulw(v, shfl(v, m, false));
  return v;
}

// inclusive product of v over the block's threads in thread order; the
// block's threads all call it (it synchronises)
__device__ fp::F block_scan(fp::F v, fp::F* s_warp) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const fp::F o = shfl(v, d, true);
    if (lane >= d) v = mulw(o, v);
  }
  if (lane == 31) s_warp[w] = v;
  __syncthreads();
  if (w == 0) {
    fp::F t = lane < WARPS ? s_warp[lane] : one();
#pragma unroll 1
    for (int d = 1; d < WARPS; d <<= 1) {
      const fp::F o = shfl(t, d, true);
      if (lane >= d) t = mulw(o, t);
    }
    if (lane < WARPS) s_warp[lane] = t;
  }
  __syncthreads();
  if (w > 0) v = mulw(s_warp[w - 1], v);
  return v;
}

// Shared state of a block.
struct Shared {
  fp::F warp[WARPS];    // block_scan's and block_product's warp values
  fp::F all[THREADS];   // the block scan's inclusive products
  fp::F product;        // block_product's result
  long long id;         // the tile
  int stop;             // look_back's nearest inclusive prefix
};

// the product of v over the block's threads, in every thread; the block's
// threads all call it (it synchronises)
__device__ fp::F block_product(fp::F v, Shared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_product(v);
  if (lane == 0) sh.warp[w] = v;
  __syncthreads();
  if (w == 0) {
    fp::F t = lane < WARPS ? sh.warp[lane] : one();
#pragma unroll 1
    for (int m = 1; m < WARPS; m <<= 1) t = mulw(t, shfl(t, m, false));
    if (lane == 0) sh.product = t;
  }
  __syncthreads();
  return sh.product;
}

// all threads: the product of tile `id`'s predecessors in its column (ids
// id - 1 ... id - depth, depth >= 1; the farthest publishes only an
// inclusive prefix), THREADS tiles a step, one a thread, stopping at the
// nearest inclusive prefix.  A step costs a block product (eight montmul
// latencies), so it looks as far back as the block reaches at once: a
// look-back that must take several steps stays long, and while it lasts
// more tiles start whose inclusive prefixes are not yet known.
__device__ fp::F look_back(const Status& st, long long id, long long depth,
                           Shared& sh) {
  fp::F acc = one();
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
    fp::F v = one();
    if (d < depth && (int)threadIdx.x <= stop)
      v = load_cg((f == INCLUSIVE ? st.inc : st.agg) + j * 8);
    acc = mulw(acc, block_product(v, sh));
    if (stop < THREADS) return acc;
  }
}

// all threads: the tile's exclusive prefix, `first` for the first tile of
// its column (depth 0), else the look-back's product; thread 0 publishes
// the aggregate A before looking back and the inclusive prefix after
__device__ fp::F tile_prefix(const Status& st, long long id, long long depth,
                             const fp::F& A, const fp::F& first,
                             Shared& sh) {
  fp::F x = first;
  if (depth > 0) {
    if (threadIdx.x == 0) publish(st.agg, st.flags, id, A, AGGREGATE);
    x = look_back(st, id, depth, sh);
  }
  if (threadIdx.x == 0) publish(st.inc, st.flags, id, mulw(x, A), INCLUSIVE);
  return x;
}

__device__ __forceinline__ long long take_tile(unsigned* counter,
                                               Shared& sh) {
  if (threadIdx.x == 0) sh.id = atomicAdd(counter, 1u);
  __syncthreads();
  return sh.id;
}

__device__ __forceinline__ int run_rows(long long end, long long first,
                                        int run) {
  const long long r = end - first;
  return r <= 0 ? 0 : (r < run ? (int)r : run);
}

// the block's inclusive scan of the run products into sh.all
__device__ __forceinline__ void scan_runs(const fp::F& g, Shared& sh) {
  sh.all[threadIdx.x] = block_scan(g, sh.warp);
  __syncthreads();
}

// Stores go through shared memory: a thread's run is `run` consecutive
// rows and the runs of a warp lie run x 32 B apart, so a warp's store of
// one row each would write 32 half-sectors, far slower than whole spans.
// Instead each thread stages CHUNK rows of its run and the block writes
// every run's CHUNK rows together: for C = 1, four 128-byte spans a warp
// store.  The slots are swizzled by the run's index, so that neither side
// has bank conflicts.  Loads stay a row a thread, issued a row ahead of
// their use.
constexpr int CHUNK = 4;
constexpr int PIECES = 2 * CHUNK;   // 16-byte pieces of a run's chunk

__device__ __forceinline__ void stage(uint4* s, int g, int r,
                                      const fp::F& v) {
  uint4* q = s + g * PIECES;
  q[(2 * r) ^ (g & 7)] = make_uint4(v.v[0], v.v[1], v.v[2], v.v[3]);
  q[(2 * r + 1) ^ (g & 7)] = make_uint4(v.v[4], v.v[5], v.v[6], v.v[7]);
}

// The rows a tile's runs cover in column c of an [n, C, 8] array: run g
// from logical row first0 + g run, the tile's rows ending at `end`;
// logical row i is physical row i, or n - 1 - i in reverse.
struct Rows {
  long long n, C, c, first0, end;
  int run, reverse;

  // the word offset of row r of run g, or -1 past the run or the tile
  __device__ __forceinline__ long long at(int g, int r) const {
    const long long i = first0 + (long long)g * run + r;
    if (r >= run || i >= end) return -1;
    return ((reverse ? n - 1 - i : i) * C + c) * 8;
  }
};

// the block writes what its runs staged for their rows j0 .. j0 + CHUNK - 1
__device__ void flush(const uint4* s, uint32_t* out, const Rows& R, int j0) {
  __syncthreads();
#pragma unroll 1
  for (int L = threadIdx.x; L < THREADS * PIECES; L += THREADS) {
    const int g = L / PIECES, piece = L % PIECES;
    const long long at = R.at(g, j0 + piece / 2);
    if (at >= 0)
      reinterpret_cast<uint4*>(out + at)[piece & 1] =
          s[g * PIECES + (piece ^ (g & 7))];
  }
  __syncthreads();
}

// -- fp252_scan_mul ----------------------------------------------------------

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
scan_kernel(const uint32_t* __restrict__ x, long long n, int C, int reverse,
            int run, long long per_col, uint32_t* status,
            uint32_t* __restrict__ out) {
  __shared__ Shared sh;
  __shared__ uint4 s_out[THREADS * PIECES];
  const Status st = status_at(status, per_col * C);
  const long long id = take_tile(st.counter, sh);
  const long long c = id / per_col, k = id % per_col;
  const Rows R = {n, C, c, k * THREADS * run, n, run, reverse};
  const int rows = run_rows(n, R.first0 + (long long)threadIdx.x * run, run);
  const long long step = reverse ? -8LL * C : 8LL * C;
  const uint32_t* xp = x + (rows ? R.at(threadIdx.x, 0) : 0);
  // 1. this thread's run product
  fp::F g = one(), next = rows ? fp::load(xp) : one();
#pragma unroll 1
  for (int r = 0; r < rows; r++) {
    const fp::F v = next;
    if (r + 1 < rows) next = fp::load(xp + (r + 1) * step);
    g = r ? mulw(g, v) : v;
  }
  // 2-3. the block's scan of the run products, the tile's prefix
  scan_runs(g, sh);
  fp::F acc = tile_prefix(st, id, k, sh.all[THREADS - 1], one(), sh);
  if (threadIdx.x > 0) acc = mulw(acc, sh.all[threadIdx.x - 1]);
  // 4. the run again (from L2), every row staged and written
  if (rows) next = fp::load(xp);
#pragma unroll 1
  for (int j0 = 0; j0 < run; j0 += CHUNK) {
    const int top = min(j0 + CHUNK, rows);
#pragma unroll 1
    for (int r = j0; r < top; r++) {
      const fp::F v = next;
      if (r + 1 < rows) next = fp::load(xp + (r + 1) * step);
      acc = mulw(acc, v);
      stage(s_out, threadIdx.x, r - j0, acc);
    }
    flush(s_out, out, R, j0);
  }
}

// -- fp252_batch_inv ---------------------------------------------------------

// a segment: [in, out, n, C, first column's index in totals / seeds]; a
// tile: [segment, column, first row, rows, index k in its column, tiles K
// of its column] (inv_tables in fields/fp252_cuda.py), its runs at
// runs[(tile * THREADS + run) * 16]: F (8 words), then G
constexpr int SEG = 5, TILE_ROW = 6;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inv_forward_kernel(const long long* __restrict__ segs,
                   const long long* __restrict__ tiles, long long ntiles,
                   int run, uint32_t* status, uint32_t* __restrict__ runs,
                   uint32_t* __restrict__ totals) {
  __shared__ Shared sh;
  __shared__ uint4 s_out[THREADS * PIECES];
  const Status st = status_at(status, ntiles);
  const long long id = take_tile(st.counter, sh);
  const long long* T = tiles + id * TILE_ROW;
  const long long* S = segs + T[0] * SEG;
  const long long c = T[1];
  const Rows R = {S[2], S[3], c, T[2], T[2] + T[3], run, 0};
  const int rows = run_rows(R.end, R.first0 + (long long)threadIdx.x * run,
                            run);
  const long long step = 8 * R.C;
  const uint32_t* xp = reinterpret_cast<const uint32_t*>(S[0]) +
                       (rows ? R.at(threadIdx.x, 0) : 0);
  // pre[i], the product of the run's rows before row i, into out
  fp::F g = one(), next = rows ? fp::load(xp) : one();
#pragma unroll 1
  for (int j0 = 0; j0 < run; j0 += CHUNK) {
    const int top = min(j0 + CHUNK, rows);
#pragma unroll 1
    for (int r = j0; r < top; r++) {
      const fp::F v = next;
      if (r + 1 < rows) next = fp::load(xp + (r + 1) * step);
      stage(s_out, threadIdx.x, r - j0, g);
      g = r ? mulw(g, v) : v;
    }
    flush(s_out, reinterpret_cast<uint32_t*>(S[1]), R, j0);
  }
  scan_runs(g, sh);
  const fp::F A = sh.all[THREADS - 1];
  const fp::F X = tile_prefix(st, id, T[4], A, one(), sh);
  if (rows > 0) {
    uint32_t* rp = runs + (id * THREADS + threadIdx.x) * 16;
    fp::store(rp, threadIdx.x ? mulw(X, sh.all[threadIdx.x - 1]) : X);
    fp::store(rp + 8, g);
  }
  if (threadIdx.x == 0 && T[4] == T[5] - 1)
    fp::store(totals + (S[4] + c) * 8, mulw(X, A));
}

// tiles in reverse order: backward tile id b takes tile ntiles - 1 - b, so
// a column's tiles come from its last to its first, with consecutive ids;
// thread t takes the tile's run THREADS - 1 - t
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
inv_backward_kernel(const long long* __restrict__ segs,
                    const long long* __restrict__ tiles, long long ntiles,
                    int run, uint32_t* status,
                    const uint32_t* __restrict__ runs,
                    const uint32_t* __restrict__ seeds) {
  __shared__ Shared sh;
  __shared__ uint4 s_out[THREADS * PIECES];
  const Status st = status_at(status, ntiles);
  const long long id = take_tile(st.counter, sh);
  const long long tile = ntiles - 1 - id;
  const long long* T = tiles + tile * TILE_ROW;
  const long long* S = segs + T[0] * SEG;
  const long long c = T[1];
  const Rows R = {S[2], S[3], c, T[2], T[2] + T[3], run, 0};
  const int mine = THREADS - 1 - threadIdx.x;
  const int rows = run_rows(R.end, R.first0 + (long long)mine * run, run);
  fp::F f = one(), g = one();
  if (rows > 0) {
    const uint32_t* rp = runs + (tile * THREADS + mine) * 16;
    f = fp::load(rp);
    g = fp::load(rp + 8);
  }
  scan_runs(g, sh);
  // the tile's exclusive suffix product, times total^-1
  const fp::F Y = tile_prefix(st, id, T[5] - 1 - T[4], sh.all[THREADS - 1],
                              fp::load(seeds + (S[4] + c) * 8), sh);
  fp::F acc = threadIdx.x ? mulw(Y, sh.all[threadIdx.x - 1]) : Y;
  acc = mulw(acc, f);   // inv(G) for this run
  // row r from the run's end: out = acc * pre, then acc *= a (the loads a
  // row ahead; a row's pre is read before the chunk that holds it is
  // written)
  uint32_t* out = reinterpret_cast<uint32_t*>(S[1]);
  const long long at0 = rows ? R.at(mine, 0) : 0, step = 8 * R.C;
  const uint32_t* op = out + at0;
  const uint32_t* xp = reinterpret_cast<const uint32_t*>(S[0]) + at0;
  fp::F pre = one(), a = one();
  if (rows) {
    pre = fp::load(op + (rows - 1) * step);
    a = fp::load(xp + (rows - 1) * step);
  }
#pragma unroll 1
  for (int j0 = (run - 1) / CHUNK * CHUNK; j0 >= 0; j0 -= CHUNK) {
#pragma unroll 1
    for (int r = min(j0 + CHUNK, rows) - 1; r >= j0; r--) {
      const fp::F p = pre, v = a;
      if (r) {
        pre = fp::load(op + (r - 1) * step);
        a = fp::load(xp + (r - 1) * step);
      }
      stage(s_out, mine, r - j0, mulw(acc, p));
      if (r) acc = mulw(acc, v);
    }
    flush(s_out, out, R, j0);
  }
}

// -- fp252_affine_scan --------------------------------------------------------

constexpr int AFFINE_MAX_RUN = 8;   // AFFINE_RUNS[-1] in fields/fp252_cuda.py
constexpr int AT = THREADS;         // a tile's threads (SCAN_THREADS)
constexpr int AWARPS = AT / 32;

// An affine map x -> x a + b and its composition, x then y: (x.a y.a,
// x.b y.a + y.b), which is not commutative; its own block routines below
// keep thread order
struct Affine {
  fp::F a, b;
};

__device__ __forceinline__ Affine aff_id() { return {one(), fp::zero()}; }

__device__ __forceinline__ Affine aff_op(const Affine& x, const Affine& y) {
  return {mulw(x.a, y.a), fp::add(mulw(x.b, y.a), y.b)};
}

__device__ __forceinline__ Affine aff_shfl(const Affine& v, int src,
                                           bool up) {
  return {shfl(v.a, src, up), shfl(v.b, src, up)};
}

// tile id's aggregate, for the tiles after it (the value, then its flag,
// as publish does for an element)
__device__ __forceinline__ void aff_publish(uint32_t* agg, unsigned* flags,
                                            long long id, const Affine& v) {
  fp::store(agg + id * 16, v.a);
  fp::store(agg + id * 16 + 8, v.b);
  __threadfence();
  st_release(flags + id, AGGREGATE);
}

// the words of the look-back state: the tile counter, a flag a tile, an
// aggregate (a map, 16 words) a tile; zeroed before each launch
__host__ __device__ __forceinline__ long long affine_status_words(
    long long tiles) {
  return 8 + (tiles + 7) / 8 * 8 + 16 * tiles;
}

// A tile's maps in shared memory: row r of run g, 16-byte half h at slot
// (r AT + g) 2 + (h ^ (g >> 2 & 1)), so that a warp's reads of one row of
// every run (and the walk's writes) meet each bank once a quarter
__device__ __forceinline__ int aff_slot(int g, int r, int h) {
  return (r * AT + g) * 2 + (h ^ ((g >> 2) & 1));
}

__device__ __forceinline__ fp::F aff_load(const uint4* s, int g, int r) {
  const uint4 x = s[aff_slot(g, r, 0)], y = s[aff_slot(g, r, 1)];
  fp::F v;
  v.v[0] = x.x; v.v[1] = x.y; v.v[2] = x.z; v.v[3] = x.w;
  v.v[4] = y.x; v.v[5] = y.y; v.v[6] = y.z; v.v[7] = y.w;
  return v;
}

__device__ __forceinline__ void aff_store(uint4* s, int g, int r,
                                          const fp::F& v) {
  s[aff_slot(g, r, 0)] = make_uint4(v.v[0], v.v[1], v.v[2], v.v[3]);
  s[aff_slot(g, r, 1)] = make_uint4(v.v[4], v.v[5], v.v[6], v.v[7]);
}

__device__ __forceinline__ void cp_async16(uint4* dst, const uint4* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

// the wait for all but the n latest groups of this thread's cp.async copies
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
  }
}

// x where c, else y, word by word (a select, not a copy through memory)
__device__ __forceinline__ Affine pick(bool c, const Affine& x,
                                       const Affine& y) {
  Affine r;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    r.a.v[k] = c ? x.a.v[k] : y.a.v[k];
    r.b.v[k] = c ? x.b.v[k] : y.b.v[k];
  }
  return r;
}

// the map m applied to x: x m.a + m.b
__device__ __forceinline__ fp::F apply(const Affine& m, const fp::F& x) {
  return fp::add(mulw(x, m.a), m.b);
}

// the product of v over the block's threads in thread order, in every
// thread; the threads from `live` on hold the identity, and a warp of
// them only skips its butterflies (each step puts the lower half's value
// first); the block's threads all call it (it synchronises)
__device__ __forceinline__ Affine aff_block_product(Affine v, int live,
                                                    Affine* s_part) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (w * 32 < live) {
#pragma unroll 1
    for (int m = 1; m < 32; m <<= 1) {
      const Affine o = aff_shfl(v, m, false);
      const bool up = lane & m;
      v = aff_op(pick(up, o, v), pick(up, v, o));
    }
  }
  if (lane == 0) s_part[w] = v;
  __syncthreads();
  if (w == 0) {
    Affine t = lane < AWARPS ? s_part[lane] : aff_id();
#pragma unroll 1
    for (int m = 1; m < AWARPS; m <<= 1) {
      const Affine o = aff_shfl(t, m, false);
      const bool up = lane & m;
      t = aff_op(pick(up, o, t), pick(up, t, o));
    }
    if (lane == 0) s_part[AWARPS] = t;
  }
  __syncthreads();
  return s_part[AWARPS];
}

// tile id takes rows id AT run ... (tiles in all), thread t its run of
// `run` rows from row (id AT + t) run; out[i + 1] = a + b of the maps
// 0..i composed, out[0] = 1
__global__ void __launch_bounds__(AT, 2)
affine_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              long long n, int run, long long tiles, uint32_t* status,
              uint32_t* __restrict__ out) {
  extern __shared__ uint4 s_maps[];      // a, then b: 2 AT run slots each
  __shared__ Affine s_warp[AWARPS];      // the warp totals' inclusive scan
  __shared__ Affine s_part[AWARPS + 1];  // aff_block_product's
  __shared__ long long s_id;
  // the look-back state (affine_status_words): counter, flags, aggregates
  unsigned* counter = reinterpret_cast<unsigned*>(status);
  unsigned* flags = counter + 8;
  uint32_t* agg = status + 8 + (tiles + 7) / 8 * 8;
  if (threadIdx.x == 0) s_id = atomicAdd(counter, 1u);
  __syncthreads();
  const long long id = s_id, first = id * AT * run;
  const int tile_rows = (int)min((long long)AT * run, n - first);
  uint4* sa = s_maps;
  uint4* sb = s_maps + 2 * AT * run;
  const int g = threadIdx.x, lane = g & 31, w = g >> 5;
  const int rows = max(0, min(run, tile_rows - g * run));
  const uint4* ga = reinterpret_cast<const uint4*>(a + first * 8);
  const uint4* gb = reinterpret_cast<const uint4*>(b + first * 8);
  // 1. this thread's run into shared memory, 16-byte cp.async copies, a
  // commit group a row, so that the composition starts on the first row
  // while the later ones arrive
#pragma unroll 1
  for (int r = 0; r < rows; r++) {
    const int q = 2 * (g * run + r);
#pragma unroll
    for (int h = 0; h < 2; h++) {
      cp_async16(sa + aff_slot(g, r, h), ga + q + h);
      cp_async16(sb + aff_slot(g, r, h), gb + q + h);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  // 2. this thread's run composed
  Affine v = aff_id();
#pragma unroll 1
  for (int r = 0; r < rows; r++) {
    cp_async_wait(rows - 1 - r);
    const Affine x = {aff_load(sa, g, r), aff_load(sb, g, r)};
    v = r ? aff_op(v, x) : x;
  }
  // 3. the warp's inclusive scan of the runs, then of the warps' totals;
  // the tile's aggregate published for the tiles after it
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const Affine o = aff_shfl(v, d, true);
    if (lane >= d) v = aff_op(o, v);
  }
  if (lane == 31) s_warp[w] = v;
  __syncthreads();
  if (w == 0) {
    Affine t = lane < AWARPS ? s_warp[lane] : aff_id();
#pragma unroll 1
    for (int d = 1; d < AWARPS; d <<= 1) {
      const Affine o = aff_shfl(t, d, true);
      if (lane >= d) t = aff_op(o, t);
    }
    if (lane < AWARPS) s_warp[lane] = t;
    if (lane == AWARPS - 1 && id + 1 < tiles)
      aff_publish(agg, flags, id, t);
  }
  __syncthreads();
  // 4. the earlier tiles' aggregates, each polled by one thread, composed
  // farthest first (thread t the step's tile t) and applied to 1
  fp::F p = one();
  if (id > 0) {
    Affine acc = aff_id();
#pragma unroll 1
    for (long long c0 = 0; c0 < id; c0 += AT) {
      const long long j = c0 + threadIdx.x;
      Affine x = aff_id();
      if (j < id) {
        while (ld_relaxed(flags + j) == 0) {
        }
        __threadfence();
        x = {load_cg(agg + j * 16), load_cg(agg + j * 16 + 8)};
      }
      const long long live = id - c0;
      acc = aff_op(acc, aff_block_product(x, live < AT ? (int)live : AT,
                                              s_part));
    }
    p = fp::add(acc.a, acc.b);
  }
  // 5. this thread's exclusive prefix applied to 1 (the earlier warps'
  // maps, then the earlier lanes'), then its run, y = y a + b a row,
  // written over the row's a
  const Affine lower = aff_shfl(v, 1, true);
  fp::F y = w ? apply(s_warp[w - 1], p) : p;
  if (lane) y = apply(lower, y);
#pragma unroll 1
  for (int r = 0; r < rows; r++) {
    y = fp::add(mulw(y, aff_load(sa, g, r)), aff_load(sb, g, r));
    aff_store(sa, g, r, y);
  }
  __syncthreads();
  // 6. the tile's rows of the column, 16 coalesced bytes a store
  uint4* go = reinterpret_cast<uint4*>(out + (first + 1) * 8);
#pragma unroll 1
  for (int q = threadIdx.x; q < 2 * tile_rows; q += AT) {
    const int row = q >> 1, gg = row / run;
    go[q] = sa[aff_slot(gg, row - gg * run, q & 1)];
  }
  if (id == 0 && threadIdx.x == 0) fp::store(out, one());
}

}  // namespace

// a, b: [n, 8] words (the maps x -> x a_k + b_k); out: [n + 1, 8], not
// overlapping them; run: 1 to AFFINE_MAX_RUN; status:
// affine_status_words(tiles) words, tiles = max(1, ceil(n / (THREADS
// run)))
extern "C" int fp252_affine_scan(const void* a, const void* b, long long n,
                                 int run, void* out, void* status,
                                 void* stream) {
  if (n < 0 || run < 1 || run > AFFINE_MAX_RUN) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  long long tiles = (n + (long long)AT * run - 1) / ((long long)AT * run);
  if (tiles < 1) tiles = 1;
  static bool sized[64];   // the kernel's shared memory limit, a device
  int dev = 0;
  cudaGetDevice(&dev);
  const int smem_max = 4 * AT * AFFINE_MAX_RUN * (int)sizeof(uint4);
  if (dev < 64 && !sized[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        affine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  const cudaError_t e =
      cudaMemsetAsync(status, 0, affine_status_words(tiles) * 4, s);
  if (e != cudaSuccess) return (int)e;
  affine_kernel<<<(unsigned)tiles, AT, 4 * AT * run * sizeof(uint4), s>>>(
      (const uint32_t*)a, (const uint32_t*)b, n, run, tiles,
      (uint32_t*)status, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// x, out: [n, C, 8] words, not overlapping; status: status_words(tiles)
// words, tiles = C * ceil(n / (THREADS * run))
extern "C" int fp252_scan_mul(const void* x, long long n, int C, int reverse,
                              int run, void* out, void* status,
                              void* stream) {
  if (n > 0 && C > 0 && run > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long per_col = (n + (long long)THREADS * run - 1) /
                              ((long long)THREADS * run);
    const long long tiles = per_col * C;
    const cudaError_t e = cudaMemsetAsync(status, 0, status_words(tiles) * 4,
                                          s);
    if (e != cudaSuccess) return (int)e;
    scan_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(
        (const uint32_t*)x, n, C, reverse, run, per_col, (uint32_t*)status,
        (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

// meta: the segment rows, then the tile rows (int64); status: two
// status_words(ntiles) areas (forward, backward); runs: ntiles * THREADS *
// 16 words; phase 0 zeroes both areas and runs the forward launch, writing
// each column's total into `values`; phase 1 runs the backward launch,
// reading each column's inverse total from `values`
extern "C" int fp252_batch_inv(const void* meta, long long nsegs,
                               long long ntiles, int run, int phase,
                               void* status, void* runs, void* values,
                               void* stream) {
  if (ntiles > 0 && run > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long* segs = (const long long*)meta;
    const long long* tiles = segs + nsegs * SEG;
    uint32_t* st = (uint32_t*)status;
    if (phase == 0) {
      const cudaError_t e =
          cudaMemsetAsync(status, 0, 2 * status_words(ntiles) * 4, s);
      if (e != cudaSuccess) return (int)e;
      inv_forward_kernel<<<(unsigned)ntiles, THREADS, 0, s>>>(
          segs, tiles, ntiles, run, st, (uint32_t*)runs, (uint32_t*)values);
    } else {
      inv_backward_kernel<<<(unsigned)ntiles, THREADS, 0, s>>>(
          segs, tiles, ntiles, run, st + status_words(ntiles),
          (const uint32_t*)runs, (const uint32_t*)values);
    }
  }
  return (int)cudaGetLastError();
}
