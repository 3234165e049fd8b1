// Kernels fp252_scan_mul and fp252_batch_inv: the Fp252 running product
// along axis 0 and the segmented Montgomery batch inversion built on it.
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
// (a1, b1) then (a2, b2) = (a1 a2, b1 a2 + b2), in ONE launch on the same
// chained-scan body (Status, look_back, tile_prefix, templated on the
// scan's element and product: Mul, Affine), a pair of 64 bytes the
// element; it writes the column the recursive and starknet layouts'
// diluted aggregate is: row 0 = 1, row k + 1 = a + b of the maps 0..k
// composed (the map applied to 1).  Replaces the XLA routine
// sandstorm_tpu/fields/scan.py:23 prefix_scan with the compose of
// sandstorm_tpu/layouts/recursive/trace.py:421-426 and
// layouts/starknet/trace.py:664-669 (in the jitted
// _build_extension_columns); the port ran log2 n Hillis-Steele stages of
// three field launches and two torch.cats (fields/scan.py's plain
// version, kept for CPU tensors).  A thread's run is composed (2
// montmuls a row), the block scans the runs' maps, the tile looks back,
// then each thread walks its run again carrying only its exclusive
// prefix applied to 1, y, and stores y = y a_k + b_k (1 montmul a row):
// 3 montmuls and 96 bytes an element.
// The composition is not commutative: the block's products keep thread
// order (warp_product's and block_product's butterflies put the lower
// half first), and the look-back gives its threads the predecessors
// farthest first, so its product is in scan order.  Stores go straight
// from the thread (a row is a whole 32-byte sector).
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

// The look-back state of one launch, in `status_words(tiles, W)` words
// (status_words in fields/fp252_cuda.py), zeroed before the launch:
// the tile counter, one flag a tile (0 nothing yet, AGGREGATE, INCLUSIVE),
// then the aggregates and the inclusive prefixes, W words a tile each (8
// for a product, 16 for an affine pair).  A
// 32- or 64-byte value cannot be published atomically with its flag: the writer
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

__host__ __device__ __forceinline__ long long status_words(long long tiles,
                                                           int W = 8) {
  return 8 + (tiles + 7) / 8 * 8 + 2LL * W * tiles;
}

__device__ __forceinline__ Status status_at(uint32_t* base, long long tiles,
                                            int W = 8) {
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

__device__ __forceinline__ fp::F load_cg(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 x = __ldcg(q), y = __ldcg(q + 1);
  fp::F r;
  r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  r.v[4] = y.x; r.v[5] = y.y; r.v[6] = y.z; r.v[7] = y.w;
  return r;
}

template <class Op>
__device__ __forceinline__ void publish(uint32_t* vals, unsigned* flags,
                                        long long id,
                                        const typename Op::T& v,
                                        unsigned flag) {
  Op::put(vals + id * Op::W, v);
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

// The scans' elements and products: Op::T (Op::W words), its identity
// id(), the product op(x, y) of x then y, a store, an L2 load and a warp
// shuffle; `ordered` where the product does not commute, so the
// butterflies must keep lane order (choosing the operands a lane costs
// Mul's kernels 2-6%, PERF.md).  Mul: an Fp252 element under
// multiplication (the running product, the batch inversion); Affine: a
// map x -> x a + b under composition, which is not commutative.
struct Mul {
  using T = fp::F;
  static constexpr int W = 8;
  static constexpr bool ordered = false;
  static __device__ __forceinline__ T id() { return one(); }
  static __device__ __forceinline__ T op(const T& x, const T& y) {
    return mulw(x, y);
  }
  static __device__ __forceinline__ void put(uint32_t* p, const T& v) {
    fp::store(p, v);
  }
  static __device__ __forceinline__ T get_cg(const uint32_t* p) {
    return load_cg(p);
  }
  static __device__ __forceinline__ T shuffle(const T& v, int src, bool up) {
    return shfl(v, src, up);
  }
};

struct Affine {
  struct T {
    fp::F a, b;
  };
  static constexpr int W = 16;
  static constexpr bool ordered = true;
  static __device__ __forceinline__ T id() { return {one(), fp::zero()}; }
  static __device__ __forceinline__ T op(const T& x, const T& y) {
    return {mulw(x.a, y.a), fp::add(mulw(x.b, y.a), y.b)};
  }
  static __device__ __forceinline__ void put(uint32_t* p, const T& v) {
    fp::store(p, v.a);
    fp::store(p + 8, v.b);
  }
  static __device__ __forceinline__ T get_cg(const uint32_t* p) {
    return {load_cg(p), load_cg(p + 8)};
  }
  static __device__ __forceinline__ T shuffle(const T& v, int src, bool up) {
    return {shfl(v.a, src, up), shfl(v.b, src, up)};
  }
};

// the product of v over the warp's 32 lanes, in every lane; in lane order
// for an ordered Op (each butterfly step puts the lower half's value first)
template <class Op>
__device__ typename Op::T warp_product(typename Op::T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int m = 1; m < 32; m <<= 1) {
    const typename Op::T o = Op::shuffle(v, m, false);
    if constexpr (!Op::ordered) {
      v = Op::op(v, o);
    } else {
      const bool up = lane & m;   // the operands chosen first: one product
      v = Op::op(up ? o : v, up ? v : o);
    }
  }
  return v;
}

// inclusive product of v over the block's threads in thread order; the
// block's threads all call it (it synchronises)
template <class Op>
__device__ typename Op::T block_scan(typename Op::T v, typename Op::T* s_warp) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll 1
  for (int d = 1; d < 32; d <<= 1) {
    const T o = Op::shuffle(v, d, true);
    if (lane >= d) v = Op::op(o, v);
  }
  if (lane == 31) s_warp[w] = v;
  __syncthreads();
  if (w == 0) {
    T t = lane < WARPS ? s_warp[lane] : Op::id();
#pragma unroll 1
    for (int d = 1; d < WARPS; d <<= 1) {
      const T o = Op::shuffle(t, d, true);
      if (lane >= d) t = Op::op(o, t);
    }
    if (lane < WARPS) s_warp[lane] = t;
  }
  __syncthreads();
  if (w > 0) v = Op::op(s_warp[w - 1], v);
  return v;
}

// Shared state of a block.
template <class Op>
struct Shared {
  typename Op::T warp[WARPS];    // block_scan's and block_product's warp values
  typename Op::T all[THREADS];   // the block scan's inclusive products
  typename Op::T product;        // block_product's result
  long long id;                  // the tile
  int stop;                      // look_back's nearest inclusive prefix
};

// the product of v over the block's threads (in thread order for an
// ordered Op), in every thread; the block's threads all call it (it
// synchronises)
template <class Op>
__device__ typename Op::T block_product(typename Op::T v, Shared<Op>& sh) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_product<Op>(v);
  if (lane == 0) sh.warp[w] = v;
  __syncthreads();
  if (w == 0) {
    T t = lane < WARPS ? sh.warp[lane] : Op::id();
#pragma unroll 1
    for (int m = 1; m < WARPS; m <<= 1) {
      const T o = Op::shuffle(t, m, false);
      if constexpr (!Op::ordered) {
        t = Op::op(t, o);
      } else {
        const bool up = lane & m;
        t = Op::op(up ? o : t, up ? t : o);
      }
    }
    if (lane == 0) sh.product = t;
  }
  __syncthreads();
  return sh.product;
}

// all threads: the product of tile `id`'s predecessors in its column (ids
// id - depth ... id - 1 in scan order, depth >= 1; the farthest publishes
// only an inclusive prefix), THREADS tiles a step, one a thread (thread t
// the step's predecessor THREADS - 1 - t: the farthest first, so the
// block's product is in scan order), stopping at the nearest inclusive
// prefix.  A step costs a block product (eight product latencies), so it
// looks as far back as the block reaches at once: a look-back that must
// take several steps stays long, and while it lasts more tiles start
// whose inclusive prefixes are not yet known.
template <class Op>
__device__ typename Op::T look_back(const Status& st, long long id,
                                    long long depth, Shared<Op>& sh) {
  using T = typename Op::T;
  T acc = Op::id();
#pragma unroll 1
  for (long long d0 = 0;; d0 += THREADS) {
    const long long d = d0 + (THREADS - 1 - threadIdx.x), j = id - 1 - d;
    unsigned f = 0;
    if (threadIdx.x == 0) sh.stop = -1;
    if (d < depth)
      while ((f = ld_relaxed(st.flags + j)) == 0) {
      }
    __threadfence();
    __syncthreads();
    if (f == INCLUSIVE) atomicMax(&sh.stop, (int)threadIdx.x);
    __syncthreads();
    const int stop = sh.stop;
    T v = Op::id();
    if (d < depth && (int)threadIdx.x >= stop)
      v = Op::get_cg((f == INCLUSIVE ? st.inc : st.agg) + j * Op::W);
    // this step's predecessors come before those of the steps before it
    acc = Op::op(block_product<Op>(v, sh), acc);
    if (stop >= 0) return acc;
  }
}

// all threads: the tile's exclusive prefix, `first` for the first tile of
// its column (depth 0), else the look-back's product; thread 0 publishes
// the aggregate A before looking back and the inclusive prefix after
template <class Op>
__device__ typename Op::T tile_prefix(const Status& st, long long id,
                                      long long depth,
                                      const typename Op::T& A,
                                      const typename Op::T& first,
                                      Shared<Op>& sh) {
  typename Op::T x = first;
  if (depth > 0) {
    if (threadIdx.x == 0) publish<Op>(st.agg, st.flags, id, A, AGGREGATE);
    x = look_back<Op>(st, id, depth, sh);
  }
  if (threadIdx.x == 0)
    publish<Op>(st.inc, st.flags, id, Op::op(x, A), INCLUSIVE);
  return x;
}

template <class Op>
__device__ __forceinline__ long long take_tile(unsigned* counter,
                                               Shared<Op>& sh) {
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
template <class Op>
__device__ __forceinline__ void scan_runs(const typename Op::T& g,
                                          Shared<Op>& sh) {
  sh.all[threadIdx.x] = block_scan<Op>(g, sh.warp);
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
  __shared__ Shared<Mul> sh;
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
  __shared__ Shared<Mul> sh;
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
  __shared__ Shared<Mul> sh;
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

// tile id takes rows id THREADS run ..., thread t its run of `run` rows
// from row (id THREADS + t) run; out[i + 1] = a + b of maps 0..i
__global__ void __launch_bounds__(THREADS, 1)
affine_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              long long n, int run, long long tiles, uint32_t* status,
              uint32_t* __restrict__ out) {
  using T = Affine::T;
  __shared__ Shared<Affine> sh;
  const Status st = status_at(status, tiles, Affine::W);
  const long long id = take_tile(st.counter, sh);
  const long long first = (id * THREADS + threadIdx.x) * run;
  const int rows = run_rows(n, first, run);
  // 1. this thread's run composed
  T g = Affine::id();
#pragma unroll 1
  for (int r = 0; r < rows; r++) {
    const T v = {fp::load(a + (first + r) * 8), fp::load(b + (first + r) * 8)};
    g = r ? Affine::op(g, v) : v;
  }
  // 2-3. the block's scan of the runs' maps, the tile's prefix
  scan_runs(g, sh);
  T acc = tile_prefix(st, id, id, sh.all[THREADS - 1], Affine::id(), sh);
  if (threadIdx.x > 0) acc = Affine::op(acc, sh.all[threadIdx.x - 1]);
  // 4. the run again from the prefix applied to 1, y = y a + b a row
  fp::F y = fp::add(acc.a, acc.b);
#pragma unroll 1
  for (int r = 0; r < rows; r++) {
    y = fp::add(mulw(y, fp::load(a + (first + r) * 8)),
                fp::load(b + (first + r) * 8));
    fp::store(out + (first + r + 1) * 8, y);
  }
  if (id == 0 && threadIdx.x == 0) fp::store(out, one());
}

}  // namespace

// a, b: [n, 8] words (the maps x -> x a_k + b_k); out: [n + 1, 8], not
// overlapping them; status: status_words(tiles, 16) words, tiles =
// max(1, ceil(n / (THREADS * run)))
extern "C" int fp252_affine_scan(const void* a, const void* b, long long n,
                                 int run, void* out, void* status,
                                 void* stream) {
  if (n < 0 || run < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  long long tiles = (n + (long long)THREADS * run - 1) /
                    ((long long)THREADS * run);
  if (tiles < 1) tiles = 1;
  const cudaError_t e =
      cudaMemsetAsync(status, 0, status_words(tiles, Affine::W) * 4, s);
  if (e != cudaSuccess) return (int)e;
  affine_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(
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
