// Kernels gl_scan_mul and gl_batch_inv: the Goldilocks (L = 2) and GF(p^3)
// (L = 6) running product along axis 0 and the segmented Montgomery batch
// inversion, one template on the element for both fields.
//
// Replaces the scans under the JAX package's GL.batch_inv and GL3.batch_inv
// (sandstorm_tpu/fields/goldilocks.py:239, gl3.py:349):
// sandstorm_tpu/fields/scan.py:57 _prefix_mul_2level and :88 prefix_mul.
// Those are XLA, not Pallas: a TPU scan is a log-depth sequence of
// full-array passes, and the port's plain version (fields/scan.py
// prefix_scan) is log2 n Hillis-Steele stages, a multiply and a copy each.
//
// gl_scan_mul, the inclusive running product of each column of an [n, C,
// L] array (from the last row in reverse), is bound on the H100 by device
// memory: an element moves 2 x L x 4 bytes, read once and written once,
// and takes two products, a run's product and the walk (8 IMAD-pipe
// issues each over GL, 72 over GF(p^3): gl3::mul's 9 Goldilocks
// products), so at [2^21, 6] 0.030 ms of bytes against 0.020 of products.
// A block takes a tile, R rows of cw columns (cw a power of two; in a
// call whose groups chain, all of the array's columns up to 32, else one:
// fields/gl_cuda.py scan_tiles), and stages it in shared memory with
// 8-byte cp.async copies, consecutive threads on consecutive words: the
// element is read from device memory once, and a warp's copies cover one
// run of addresses wherever the tile spans the array's columns.  Thread t
// works on column t / P (P = 256 / cw threads a column) and on m
// consecutive rows of it (R = P m): it forms their product as two chains
// of independent products (the first and the second half of its rows), a
// scan over the column's threads (warp shuffles, then the warps' products)
// gives its exclusive prefix within the tile and the tile column's
// product, and it walks both halves again in shared memory (acc *= a, a
// overwritten by acc; the second half from the prefix times the first
// half's product); the block then stores the tile with coalesced 8-byte
// stores.  A thread's rows are a span of m L / 2 u64 words, padded to an
// odd count ((m L / 2) | 1): the spans of a half-warp's 16 threads start
// an odd stride apart, so their words lie in distinct banks (padding, not
// a swizzle).  Where a column group takes more than one tile, its tiles
// chain by decoupled look-back (a block takes the next tile id from an
// atomic counter, so every tile it waits for belongs to a block that is
// already running; in reverse a group's first tile is its last row
// block): the tile publishes its cw aggregates, the column's threads look
// back over P predecessors a step until they meet an inclusive prefix, the
// tile publishes its inclusive prefixes, and each thread folds the product
// of the predecessors into its prefix; that call is a memset of the
// look-back state and the launch.  Where every group fits one tile (the
// opener's power tables, small calls) there is no look-back and no memset:
// the call is one launch.  What it leaves, as measured on the H100: a
// block stages, multiplies and stores in turn, so its copies overlap only
// other blocks' products; the scan over a tile's threads and the
// look-back (a block-wide product a step, mostly of ones) grow with the
// tiles and weigh most beside the walk; a GF(p^3) thread holds 114
// registers, two blocks an SM.  A block that stages its next tile while
// it scans this one (two buffers, as many blocks as the card holds) and
// a look-back and scan by one warp were both slower.
//
// gl_batch_inv inverts every column of several arrays (segments) in ONE
// launch, with no look-back and no host trip: Montgomery's trick within a
// tile, so no tile waits for another.  A block takes one tile, a span of
// rows of one segment across all of its columns where they fit
// (fields/gl_cuda.py inv_segments; a segment of more columns than a tile
// holds is cut into column groups), and stages it in shared memory with
// coalesced 8-byte loads, INV_LOADS in flight a thread.  For each column,
// thread t takes rows t, t + INV_THREADS, ... (consecutive threads on
// consecutive elements: no bank conflict) as two chains, its even and its
// odd rows, keeping in registers the products of each row's chain before
// it (pre) and each chain's product g.  The block pass is over Goldilocks
// values: g^-1 = t N(g)^-1 with N(g) = g g^p g^(p^2) in GF(p) and
// t = g^p g^(p^2) (goldilocks.cuh gl3::norm, the route of the host's
// Fq3S.inv; over GL the norm is g), so one pass of warp shuffles over the
// threads' N(g0) N(g1) gives each thread the products of the threads
// before (x) and after (y) it and the tile column's product G, one thread
// inverts G (gl::inv, a Fermat power by a fixed chain), and each chain
// walks back from its g^-1: out = acc pre, acc *= a, written over a in
// shared memory, then stored with coalesced stores.  The element is read
// once and written once; pre never leaves the chip.  A column whose tile
// holds a zero has G = 0 (a norm is zero only for zero), comes out zero
// in that tile and sets its flag; the last block to finish (an atomic
// count of finished tiles) zeroes every flagged column in all of its rows,
// so a zero in a column makes that column's inverses all zero, and no
// other column's, as in the JAX package.  Nothing is read back to the
// host.
//
// Bound on the H100: device memory.  A GL multiply is 8 IMAD-pipe issues
// (four 32 x 32 products, lo and hi), a GF(p^3) multiply 9 of them (72);
// a row moves 2 x 8 (24) bytes, so the bytes bound the scan in both
// fields; the batch inversion's least work is an element read and written
// once and 3 products an element, and over GF(p^3) its two bounds are
// about equal.  A tile holds INV_ROWS[L] rows of one column (16 a thread
// over GL, 8 over GF(p^3): pre's registers); its fixed cost, the block
// pass and one inversion of about 73 dependent Goldilocks products, is
// what the tile's rows amortise.
#include <cuda_runtime.h>

#include <cstring>

#include "goldilocks.cuh"

namespace {

// -- gl_batch_inv ------------------------------------------------------------

constexpr int INV_THREADS = 256;   // INV_THREADS in fields/gl_cuda.py
constexpr int INV_WARPS = INV_THREADS / 32;
constexpr int INV_SEG = 8;         // words of a segment row (INV_SEG)
constexpr int INV_MAX_SEGS = 32;   // segments a launch (INV_MAX_SEGS)
constexpr int INV_LOADS = 8;       // a thread's staging loads in flight

// rows a thread holds in a column (INV_ROWS[L] / INV_THREADS in
// fields/gl_cuda.py): the products before each stay in registers
template <class Fd>
struct InvRows;
template <>
struct InvRows<GLF> {
  static constexpr int M = 16;
};
template <>
struct InvRows<GL3F> {
  static constexpr int M = 8;
};

// the segment rows, by value in the launch's parameters: [in, out, n, C,
// rows a tile R, columns a tile cw, first tile, first column (its flag's
// index)]; a segment's tiles are its row blocks of R rows, each cut into
// column groups of cw columns (consecutive tile ids)
struct InvSegs {
  long long w[INV_MAX_SEGS * INV_SEG];
};

// the block pass of a tile column, over Goldilocks values (the thread
// products' norms)
struct InvShared {
  uint64_t warp[INV_WARPS];    // each warp's product
  uint64_t before[INV_WARPS];  // the warps' products before each
  uint64_t after[INV_WARPS];   // and after it
  uint64_t total;              // the tile column's product of norms
  uint64_t inv;                // and its inverse
  int last;                    // this block finished last
};

// all threads: the product of v over the block's threads (returned) and,
// in x and y, over the threads before and after this one
__device__ uint64_t block_products(uint64_t v, uint64_t& x, uint64_t& y,
                                   InvShared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint64_t f = v, b = v;   // products of the lanes up to and from this one
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t of = GLF::shfl_up(f, d), ob = GLF::shfl_down(b, d);
    if (lane >= d) f = gl::mul(of, f);
    if (lane + d < 32) b = gl::mul(b, ob);
  }
  uint64_t xf = GLF::shfl_up(f, 1), yb = GLF::shfl_down(b, 1);
  if (lane == 0) xf = 1;
  if (lane == 31) {
    yb = 1;
    sh.warp[w] = f;
  }
  __syncthreads();
  if (w == 0) {
    uint64_t tf = lane < INV_WARPS ? sh.warp[lane] : 1, tb = tf;
#pragma unroll
    for (int d = 1; d < INV_WARPS; d <<= 1) {
      const uint64_t of = GLF::shfl_up(tf, d), ob = GLF::shfl_down(tb, d);
      if (lane >= d) tf = gl::mul(of, tf);
      if (lane + d < INV_WARPS) tb = gl::mul(tb, ob);
    }
    const uint64_t ef = GLF::shfl_up(tf, 1), eb = GLF::shfl_down(tb, 1);
    if (lane < INV_WARPS) {
      sh.before[lane] = lane ? ef : 1;
      sh.after[lane] = lane + 1 < INV_WARPS ? eb : 1;
    }
    if (lane == INV_WARPS - 1) sh.total = tf;
  }
  __syncthreads();
  x = gl::mul(sh.before[w], xf);
  y = gl::mul(yb, sh.after[w]);
  return sh.total;
}

// element i of a staged column (W / 2 u64 words an element)
template <class Fd>
__device__ __forceinline__ typename Fd::E tile_ld(const uint64_t* col,
                                                  int i) {
  return Fd::load(reinterpret_cast<const uint32_t*>(col + i * (Fd::W / 2)));
}

template <class Fd>
__device__ __forceinline__ void tile_st(uint64_t* col, int i,
                                        const typename Fd::E& v) {
  Fd::store(reinterpret_cast<uint32_t*>(col + i * (Fd::W / 2)), v);
}

// one block a tile; scratch: the finished-tile counter, then a flag a
// column of the launch (zeroed before it)
template <class Fd>
__global__ void __launch_bounds__(INV_THREADS, 2)
inv_tile_kernel(const InvSegs segs, int nsegs, unsigned ntiles,
                unsigned* __restrict__ scratch) {
  using E = typename Fd::E;
  constexpr int M = InvRows<Fd>::M, H = Fd::W / 2;
  extern __shared__ uint64_t tile[];   // [cols][rows] elements
  __shared__ InvShared sh;
  __shared__ long long S[INV_SEG];     // the tile's segment row
  const int t = threadIdx.x;
  const long long id = blockIdx.x;
  // (the parameters are indexed, never addressed: no local copy)
  int s = 0;
  while (s + 1 < nsegs && segs.w[(s + 1) * INV_SEG + 6] <= id) s++;
  if (t < INV_SEG) S[t] = segs.w[s * INV_SEG + t];
  __syncthreads();
  const uint64_t* in = reinterpret_cast<const uint64_t*>(S[0]);
  uint64_t* out = reinterpret_cast<uint64_t*>(S[1]);
  const long long n = S[2], C = S[3], R = S[4], cw = S[5];
  const long long groups = (C + cw - 1) / cw, k = id - S[6];
  const long long r0 = k / groups * R, c0 = k % groups * cw;
  const int rows = (int)(n - r0 < R ? n - r0 : R);
  const int cols = (int)(C - c0 < cw ? C - c0 : cw);
  // the tile's u64 word q: its global index, and its staged place at
  // ([cols][rows], each column one run of rows)
  const long long words = (long long)rows * cols * H;
  auto global_at = [&](long long q, long long& at) {
    const long long e = q / H, h = q - e * H;
    const long long r = cols == 1 ? e : e / cols, c = e - r * cols;
    at = (c * rows + r) * H + h;
    return ((r0 + r) * C + c0 + c) * H + h;
  };
  // INV_LOADS loads in flight a thread: a load waits on device memory,
  // a store to shared memory on its load
#pragma unroll 1
  for (long long q0 = t; q0 < words; q0 += INV_THREADS * INV_LOADS) {
    uint64_t v[INV_LOADS];
    long long at[INV_LOADS];
#pragma unroll
    for (int u = 0; u < INV_LOADS; u++) {
      const long long q = q0 + u * INV_THREADS;
      if (q < words) v[u] = in[global_at(q, at[u])];
    }
#pragma unroll
    for (int u = 0; u < INV_LOADS; u++)
      if (q0 + u * INV_THREADS < words) tile[at[u]] = v[u];
  }
  __syncthreads();
  const int m = t < rows ? (rows - 1 - t) / INV_THREADS + 1 : 0;
#pragma unroll 1
  for (int c = 0; c < cols; c++) {
    uint64_t* col = tile + (long long)c * rows * H;
    // two chains a thread, its even and its odd rows (two independent
    // products in flight): pre[j], the product of the rows of j's chain
    // before it, and g[k], chain k's product
    E pre[M];
    E g[2] = {Fd::one(), Fd::one()};
#pragma unroll
    for (int j = 0; j < M; j++)
      if (j < m) {
        const E a = tile_ld<Fd>(col, t + j * INV_THREADS);
        pre[j] = g[j & 1];
        g[j & 1] = j < 2 ? a : Fd::mul(g[j & 1], a);
      }
    // the block pass over Goldilocks values: g^-1 = tg N(g)^-1, and the
    // norms' product G is zero only where an element of the column is
    E tg[2];
    const uint64_t n0 = Fd::norm(g[0], tg[0]), n1 = Fd::norm(g[1], tg[1]);
    uint64_t x, y;
    const uint64_t G = block_products(gl::mul(n0, n1), x, y, sh);
    if (t == 0) {
      sh.inv = gl::inv(G);
      if (G == 0) scratch[1 + S[7] + c0 + c] = 1;
    }
    __syncthreads();
    const uint64_t q = gl::mul(gl::mul(sh.inv, x), y);   // (n0 n1)^-1
    E acc[2] = {Fd::scale(tg[0], gl::mul(q, n1)),       // g[0]^-1
                Fd::scale(tg[1], gl::mul(q, n0))};      // g[1]^-1
#pragma unroll
    for (int j = M - 1; j >= 0; j--)
      if (j < m) {
        const int i = t + j * INV_THREADS;
        const E a = tile_ld<Fd>(col, i);
        E& w = acc[j & 1];
        tile_st<Fd>(col, i, j < 2 ? w : Fd::mul(w, pre[j]));
        if (j >= 2) w = Fd::mul(w, a);
      }
    __syncthreads();
  }
#pragma unroll 1
  for (long long q = t; q < words; q += INV_THREADS) {
    long long at;
    const long long g = global_at(q, at);
    out[g] = tile[at];
  }
  // the last block to finish zeroes every flagged column, all its rows
  __threadfence();
  __syncthreads();
  if (t == 0) sh.last = atomicAdd(scratch, 1u) == ntiles - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
#pragma unroll 1
  for (int z = 0; z < nsegs; z++) {
    uint64_t* zout = reinterpret_cast<uint64_t*>(segs.w[z * INV_SEG + 1]);
    const long long zn = segs.w[z * INV_SEG + 2];
    const long long zC = segs.w[z * INV_SEG + 3];
    const long long zf = segs.w[z * INV_SEG + 7];
#pragma unroll 1
    for (long long c = 0; c < zC; c++) {
      if (!__ldcg(scratch + 1 + zf + c)) continue;
#pragma unroll 1
      for (long long r = t; r < zn; r += INV_THREADS)
#pragma unroll
        for (int h = 0; h < H; h++) zout[(r * zC + c) * H + h] = 0;
    }
  }
}

template <class Fd>
int inv_tiles_launch(const InvSegs& segs, int nsegs, long long ntiles,
                     unsigned* scratch, cudaStream_t s) {
  // shared memory for the launch's largest tile
  long long elems = 0;
  for (int k = 0; k < nsegs; k++) {
    const long long* S = segs.w + k * INV_SEG;
    const long long rows = S[2] < S[4] ? S[2] : S[4];
    const long long cols = S[3] < S[5] ? S[3] : S[5];
    if (rows * cols > elems) elems = rows * cols;
  }
  const size_t bytes = (size_t)elems * Fd::W * 4;
  const cudaError_t e = cudaFuncSetAttribute(
      inv_tile_kernel<Fd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  inv_tile_kernel<Fd><<<(unsigned)ntiles, INV_THREADS, bytes, s>>>(
      segs, nsegs, (unsigned)ntiles, scratch);
  return (int)cudaGetLastError();
}

// -- gl_scan_mul -------------------------------------------------------------

constexpr int SCAN_THREADS = 256;   // SCAN_THREADS in fields/gl_cuda.py
constexpr int SCAN_LOG_THREADS = 8;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_MAX_COLS = 32;   // columns a tile (SCAN_MAX_COLS)
constexpr int SCAN_MAX_RUN = 32;    // rows a thread (SCAN_MAX_RUN)
constexpr unsigned AGGREGATE = 1, INCLUSIVE = 2;

// The look-back state of a launch whose column groups take more than one
// tile, scan_status_words(tiles, cw, W) words (fields/gl_cuda.py), zeroed
// before the launch: the tile counter, one flag a tile (0 nothing yet,
// AGGREGATE, INCLUSIVE), then the aggregates and the inclusive prefixes,
// cw elements (cw W words) a tile each.  The writers store their values
// and fence, the block synchronises, then one thread sets the flag with a
// release store; the reader polls the flags with relaxed loads, fences
// once they are all set, then loads the values from L2.  Aggregate and
// inclusive prefix have slots of their own.
struct Status {
  unsigned* counter;
  unsigned* flags;
  uint32_t* agg;
  uint32_t* inc;
};

__host__ __device__ __forceinline__ long long scan_status_words(
    long long tiles, int cw, int W) {
  return 8 + (tiles + 7) / 8 * 8 + 2LL * W * cw * tiles;
}

__device__ __forceinline__ Status status_at(uint32_t* base, long long tiles,
                                            int cw, int W) {
  const long long f = (tiles + 7) / 8 * 8, v = (long long)W * cw * tiles;
  return {base, base + 8, base + 8 + f, base + 8 + f + v};
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// an 8-byte copy from device memory into shared memory, not waited for
__device__ __forceinline__ void cp_async8(uint64_t* dst, const uint64_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Shared state of a block besides its tile.
template <class Fd>
struct ScanShared {
  typename Fd::E warp[SCAN_WARPS];     // col_scan's warp products
  typename Fd::E tot[SCAN_MAX_COLS];   // col_scan's column products
  unsigned flag[SCAN_THREADS];         // look_back's flags, a predecessor a
                                       // thread of column 0
  long long id;                        // the tile
  int stop;                            // look_back's nearest inclusive prefix
};

// all threads: the product of v over this thread's column's threads before
// it (ex) and up to it (returned), a column being P = 2^lp consecutive
// threads, and each column's product in sh.tot
template <class Fd>
__device__ typename Fd::E col_scan(typename Fd::E v, typename Fd::E& ex,
                                   int lp, ScanShared<Fd>& sh) {
  using E = typename Fd::E;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int P = 1 << lp, pl = P < 32 ? P : 32;   // its lanes in a warp
  const int pos = lane & (pl - 1);
#pragma unroll 1
  for (int d = 1; d < pl; d <<= 1) {
    const E o = Fd::shfl_up(v, d);
    if (pos >= d) v = Fd::mul(o, v);
  }
  ex = Fd::shfl_up(v, 1);
  if (pos == 0) ex = Fd::one();
  if (P > 32) {   // a column spans P / 32 warps
    const int wp = P >> 5;
    if (lane == 31) sh.warp[w] = v;
    __syncthreads();
    if (w == 0) {
      E s = lane < SCAN_WARPS ? sh.warp[lane] : Fd::one();
#pragma unroll 1
      for (int d = 1; d < wp; d <<= 1) {
        const E o = Fd::shfl_up(s, d);
        if ((lane & (wp - 1)) >= d) s = Fd::mul(o, s);
      }
      if (lane < SCAN_WARPS) sh.warp[lane] = s;
    }
    __syncthreads();
    if (w & (wp - 1)) {
      const E c = sh.warp[w - 1];
      v = Fd::mul(c, v);
      ex = lane ? Fd::mul(c, ex) : c;
    }
  }
  // (every thread has read the last call's sh.tot)
  __syncthreads();
  if ((t & (P - 1)) == P - 1) sh.tot[t >> lp] = v;
  __syncthreads();
  return v;
}

// all threads: for this thread's column, the product of tile id's
// predecessors in its column group (ids id - groups, id - 2 groups, ...,
// depth >= 1 of them; the farthest publishes only an inclusive prefix),
// P = 2^lp tiles a step, one a thread of the column, stopping at the
// nearest inclusive prefix; column 0's threads read the flags for all
template <class Fd>
__device__ typename Fd::E look_back(const Status& st, long long id,
                                    long long groups, long long depth,
                                    int col, int cols, int cw, int lp,
                                    ScanShared<Fd>& sh) {
  using E = typename Fd::E;
  const int P = 1 << lp, p = threadIdx.x & (P - 1);
  E acc = Fd::one();
#pragma unroll 1
  for (long long d0 = 0;; d0 += P) {
    if (threadIdx.x == 0) sh.stop = P;
    if (threadIdx.x < P) {
      const long long d = d0 + threadIdx.x;
      unsigned f = 0;
      if (d < depth)
        while ((f = ld_relaxed(st.flags + id - (d + 1) * groups)) == 0) {
        }
      sh.flag[threadIdx.x] = f;
    }
    __threadfence();
    __syncthreads();
    const unsigned f = sh.flag[p];
    if (col == 0 && f == INCLUSIVE) atomicMin(&sh.stop, p);
    __syncthreads();
    __threadfence();
    const int stop = sh.stop;
    const long long d = d0 + p, j = id - (d + 1) * groups;
    E v = Fd::one();
    if (d < depth && p <= stop && col < cols)
      v = Fd::load_cg((f == INCLUSIVE ? st.inc : st.agg) +
                      (j * cw + col) * Fd::W);
    E ex;
    col_scan<Fd>(v, ex, lp, sh);
    acc = Fd::mul(acc, sh.tot[col]);
    if (stop < P) return acc;
  }
}

// all threads: tile id's prefix for this thread's column (row block k of
// per_group, its columns' products A), the product of its group's earlier
// tiles, one for the group's first tile; column col's thread p = 0
// publishes the column's aggregate before looking back and its inclusive
// prefix after, unless no tile waits for this one (the group's last)
template <class Fd>
__device__ typename Fd::E tile_prefix(const Status& st, long long id,
                                      long long groups, long long k,
                                      long long per_group,
                                      const typename Fd::E& A, int col,
                                      int cols, int cw, int lp,
                                      ScanShared<Fd>& sh) {
  using E = typename Fd::E;
  const bool writer = (threadIdx.x & ((1 << lp) - 1)) == 0 && col < cols;
  const bool last = k + 1 == per_group;
  const long long at = (id * cw + col) * Fd::W;
  E x = Fd::one();
  if (k > 0) {
    if (!last) {
      if (writer) Fd::store(st.agg + at, A);
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) st_release(st.flags + id, AGGREGATE);
    }
    x = look_back<Fd>(st, id, groups, k, col, cols, cw, lp, sh);
  }
  if (!last) {
    if (writer) Fd::store(st.inc + at, k > 0 ? Fd::mul(x, A) : A);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(st.flags + id, INCLUSIVE);
  }
  return x;
}

// a thread's words of a tile, q = t, t + SCAN_THREADS, ...: each one's row
// r and word rem in it (q = r wu + rem, wu words a row), stepped by
// SCAN_THREADS words; q / wu = floor(q inv / 2^32) exactly while q wu <
// 2^32 (a tile holds at most SCAN_THREADS SCAN_MAX_RUN 3 words)
struct TileWords {
  int r, rem, dr, drem;
  __device__ __forceinline__ TileWords(int t, int wu) {
    const unsigned long long inv = 0xFFFFFFFFull / wu + 1;
    r = (int)((unsigned long long)t * inv >> 32);
    rem = t - r * wu;
    dr = (int)((unsigned long long)SCAN_THREADS * inv >> 32);
    drem = SCAN_THREADS - dr * wu;
  }
  __device__ __forceinline__ void next(int wu) {
    r += dr;
    rem += drem;
    if (rem >= wu) {
      rem -= wu;
      r++;
    }
  }
};

// x, out: [n, C, W] words; logical row i is physical row i, or n - 1 - i
// in reverse.  A tile is R = 2^(lm + lp) logical rows (2^lm a thread, P =
// 2^lp threads a column) of cw = 2^lcw columns; tile id is row block
// id / groups of column group id % groups; per_group row blocks a group
// (look-back and the tile counter only where per_group > 1)
template <class Fd>
__global__ void __launch_bounds__(SCAN_THREADS, 2)
scan_kernel(const uint64_t* __restrict__ x, long long n, int C, int reverse,
            int lm, int lcw, long long per_group, uint32_t* status,
            uint64_t* __restrict__ out) {
  using E = typename Fd::E;
  constexpr int H = Fd::W / 2;   // u64 words an element
  extern __shared__ uint64_t tile[];
  __shared__ ScanShared<Fd> sh;
  const int t = threadIdx.x;
  const int m = 1 << lm, cw = 1 << lcw, lp = SCAN_LOG_THREADS - lcw;
  const int R = m << lp;
  const long long groups = (C + cw - 1) >> lcw;
  Status st{};
  long long id = blockIdx.x;
  if (per_group > 1) {
    st = status_at(status, per_group * groups, cw, Fd::W);
    if (t == 0) sh.id = atomicAdd(st.counter, 1u);
    __syncthreads();
    id = sh.id;
  }
  const long long k = id / groups;
  const int c0 = (int)(id - k * groups) << lcw;
  const int cols = min(cw, C - c0);
  const long long first = k * R;   // the tile's first logical row
  const int rows = (int)min((long long)R, n - first);
  const long long lo = reverse ? n - first - rows : first;   // physical
  const int wu = cols * H;         // u64 words of a tile row
  const int words = rows * wu, span = (m * H) | 1;
  const long long stride = (long long)C * H;
  const long long base = (lo * C + c0) * H;
  // the staged place of the tile's word rem of row r: thread (column,
  // row / m)'s span, element row % m
  auto place = [&](int r, int rem) {
    const int c = rem / H, h = rem - c * H;
    const int l = reverse ? rows - 1 - r : r;
    return ((c << lp) + (l >> lm)) * span + (l & (m - 1)) * H + h;
  };
  TileWords w(t, wu);
#pragma unroll 4
  for (int q = t; q < words; q += SCAN_THREADS, w.next(wu))
    cp_async8(tile + place(w.r, w.rem), x + base + w.r * stride + w.rem);
  cp_async_wait_all();
  __syncthreads();
  const int col = t >> lp, p = t & ((1 << lp) - 1);
  const int own = col < cols ? max(0, min(m, rows - p * m)) : 0;
  uint64_t* mine = tile + t * span;
  // 1. the product of this thread's rows, as two chains of independent
  // products: rows 0 .. h - 1 and h .. m - 1 (none for m = 1); a row past
  // the tile's counts as one
  const int h = (m + 1) >> 1;
  auto row = [&](int i) {
    return i < own ? tile_ld<Fd>(mine, i) : Fd::one();
  };
  E g0 = row(0), g1 = m > 1 ? row(h) : Fd::one();
#pragma unroll 1
  for (int i = 1; i < h; i++) {
    g0 = Fd::mul(g0, row(i));
    g1 = Fd::mul(g1, row(h + i));
  }
  // 2. its prefix within the tile, the tile column's product
  E ex;
  col_scan<Fd>(Fd::mul(g0, g1), ex, lp, sh);
  const E A = sh.tot[col];
  // 3. the tile's prefix, where its group has tiles before it
  if (per_group > 1) {
    const E pre = tile_prefix<Fd>(st, id, groups, k, per_group, A, col,
                                  cols, cw, lp, sh);
    if (k > 0) ex = Fd::mul(pre, ex);
  }
  // 4. the walk over the staged rows, both chains (rows past the tile's
  // take any value: they are not stored)
  if (m == 1) {
    tile_st<Fd>(mine, 0, Fd::mul(ex, tile_ld<Fd>(mine, 0)));
  } else {
    E acc1 = Fd::mul(ex, g0);
#pragma unroll 1
    for (int i = 0; i < h; i++) {
      ex = Fd::mul(ex, tile_ld<Fd>(mine, i));
      acc1 = Fd::mul(acc1, tile_ld<Fd>(mine, h + i));
      tile_st<Fd>(mine, i, ex);
      tile_st<Fd>(mine, h + i, acc1);
    }
  }
  __syncthreads();
  TileWords v(t, wu);
#pragma unroll 4
  for (int q = t; q < words; q += SCAN_THREADS, v.next(wu))
    out[base + v.r * stride + v.rem] = tile[place(v.r, v.rem)];
}

template <class Fd>
int scan_launch(const void* x, long long n, int C, int reverse, int lm,
                int lcw, void* out, void* status, cudaStream_t s) {
  constexpr int H = Fd::W / 2;
  const long long R = (long long)(SCAN_THREADS >> lcw) << lm;
  const long long per_group = (n + R - 1) / R;
  const long long groups = (C + (1LL << lcw) - 1) >> lcw;
  const long long tiles = per_group * groups;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (per_group > 1) {
    if (!status) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaMemsetAsync(
        status, 0, scan_status_words(tiles, 1 << lcw, Fd::W) * 4, s);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t bytes = (size_t)SCAN_THREADS * (((1 << lm) * H) | 1) * 8;
  const cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<Fd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  scan_kernel<Fd><<<(unsigned)tiles, SCAN_THREADS, bytes, s>>>(
      (const uint64_t*)x, n, C, reverse, lm, lcw, per_group,
      (uint32_t*)status, (uint64_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [n, C, L] words (L = 2: GL, 6: GF(p^3)), 8-byte aligned, not
// overlapping; a tile of 2^lm rows a thread and 2^lcw columns
// (fields/gl_cuda.py scan_tiles); status: scan_status_words(tiles, 2^lcw,
// L) words where a column group takes more than one tile (zeroed here
// before the launch), else unused (may be null): the call is then one
// launch
extern "C" int gl_scan_mul(const void* x, long long n, int C, int reverse,
                           int lm, int lcw, int L, void* out, void* status,
                           void* stream) {
  if ((L != 2 && L != 6) || lm < 0 || (1 << lm) > SCAN_MAX_RUN || lcw < 0 ||
      (1 << lcw) > SCAN_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && C > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    return L == 2
               ? scan_launch<GLF>(x, n, C, reverse, lm, lcw, out, status, s)
               : scan_launch<GL3F>(x, n, C, reverse, lm, lcw, out, status, s);
  }
  return (int)cudaGetLastError();
}

// segs: nsegs segment rows of INV_SEG int64 words in HOST memory (copied
// into the launch's parameters: fields/gl_cuda.py inv_segments), their
// tiles numbered 0 .. ntiles - 1; scratch: 1 + ncols u32 words on the
// device (the finished-tile counter, a flag a column), zeroed here before
// the one launch
extern "C" int gl_batch_inv(const long long* segs, int nsegs,
                            long long ntiles, long long ncols, int L,
                            void* scratch, void* stream) {
  if ((L != 2 && L != 6) || nsegs < 1 || nsegs > INV_MAX_SEGS ||
      ntiles < 1 || ntiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  InvSegs table;
  memcpy(table.w, segs, sizeof(long long) * INV_SEG * nsegs);
  const cudaError_t e =
      cudaMemsetAsync(scratch, 0, (size_t)(1 + ncols) * 4, s);
  if (e != cudaSuccess) return (int)e;
  unsigned* sc = (unsigned*)scratch;
  return L == 2 ? inv_tiles_launch<GLF>(table, nsegs, ntiles, sc, s)
                : inv_tiles_launch<GL3F>(table, nsegs, ntiles, sc, s);
}
