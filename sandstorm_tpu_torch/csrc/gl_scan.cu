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
// gl_scan_mul is csrc/scan.cu's design (the Fp252 scan) with the element a
// u64 or three: ONE launch, a chained scan with decoupled look-back (a
// block takes the next tile id from an atomic counter, so every tile it
// waits for belongs to a block that is already running; a tile is THREADS
// runs of `run` rows): each thread multiplies its run, the block scans the
// run products and publishes the tile's aggregate, looks back over its
// predecessors' aggregates and inclusive prefixes until it meets an
// inclusive one, publishes its inclusive prefix, and each thread walks its
// run again from its exclusive prefix.  What it leaves: the stores are a
// row a thread (run rows apart within a warp), and the look-back's serial
// products.
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
