// Kernel gl_deep_compose: the DEEP composition over Goldilocks (L = 2) and
// GF(p^3) (L = 6) at every row of the LDE domain, from the denominators'
// inverses read at shifted rows: csrc/deep.cu's form for the two fields,
// one template on the element (goldilocks.cuh GLF / GL3F).
//
// Replaces the JAX package's DEEP dispatches over GL and GL3,
// sandstorm_tpu/stark/prover.py:488 _deep_den_fwd and :498 _deep_den_bwd
// (under :509 _deep_den_scans: every 1 / (x - pt_k) of a window as a
// [K, B] stack) and :527 _deep_apply_point / :539 _deep_apply_group, under
// :554 _deep_compose.
//
// The LDE domain is x_i = coset w^i and every trace point is z g^o with
// g = w^b (b the blowup, o taken mod the trace length), so
//     1 / (x_i - z g^o) = g^-o u[(i - o b) mod N],   u = 1 / (x - z),
// and the composition point's inverses are v = 1 / (x - z^m).  The host
// (stark/prover.py deep_prepare) inverts u and v in one gl_batch_inv call
// (csrc/gl_scan.cu), folds g^-o into each term's coefficient (a_j =
// c_j g^-o, in the extension field over GF(p^3)) and each point's constant
// into C_k = sum_j a_j t_j, and orders the columns base-field first; the
// kernel computes, for each row,
//     D(x_i) = sum_k inv_k(i) (sum_{j of point k} a_j T_j(x_i) - C_k),
// inv_k(i) = u[(i - shift_k) & (N - 1)] for a trace point, v[i] for the
// composition point.
//
// Bound on the H100: the products.  Over GF(p^3) a term on a base-field
// column (the prover's base trace, named by base_cols) is 3 Goldilocks
// products (mac_base, its column read as one u64), any other term and
// each point's product by its inverse 9 (mac, the schoolbook on a_j's
// doubled upper coordinates, prepared on the host); over Goldilocks one
// each.  Design (the generic kernel, not one rendered a term table: the
// tables are few and small, and a generic kernel needs no build a
// layout): 128 threads a block, one row a thread over GF(p^3) and two
// over GL.  The tables (terms' column slots, a_j, C_k, first terms,
// shifts, inverse tables) are staged once a block in shared memory, so the
// term loop reads them as broadcasts, not as dependent global loads; each
// thread first reads each distinct column's row once (a base column's c0
// word, an extension column's three; ROW_LOADS columns in flight) into
// its slots in shared memory, [slot][rows] u64 (no bank conflict), and
// the terms read the slots.  A point's sum is unreduced (gl::Wide a
// coordinate: gl3::W3, its carries in the condition-code register:
// mac_cc), reduced once, less C_k, and its product by the inverse (loaded
// before the point's terms) is added unreduced to the row's sum, reduced
// once a row.  The shifted reads of u fall within the offsets' span of
// rows behind the resident blocks, which L2 holds.  Row indices are
// 32-bit words (the wrapper refuses a domain where they would not fit).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ROW_LOADS = 4;   // columns whose row loads are in flight

// rows a thread: over GL two (the table reads and the loop serve both),
// over GF(p^3) one (a row's unreduced sums are 30 registers already)
template <class Fd>
__host__ __device__ constexpr int rows_of() {
  return Fd::W == 2 ? 2 : 1;
}

// DEEP's unreduced sums (gl::Wide a coordinate, gl3::W3), each product
// added with its carries in the condition-code register: add.cc /
// addc.cc / addc, 5 integer adds where gl::mac's adds and compares take
// 11 (this kernel runs about 366 of them a row).  One short chain in one
// asm statement, not the long interleaved chains ptxas miscompiled in
// fp252.cuh; the other kernels on goldilocks.cuh keep gl::mac.
__device__ __forceinline__ void mac_cc(gl::Wide& w, uint64_t a, uint64_t b) {
  const uint64_t l = a * b, h = __umul64hi(a, b);
  asm("add.cc.u64 %0, %0, %3;\n\t"
      "addc.cc.u64 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+l"(w.lo), "+l"(w.hi), "+r"(w.c)
      : "l"(l), "l"(h));
}

// w += a b and w += z b for a base value b, the forms of GLF / GL3F::mac
// and mac_base (gl3::mac's 9 products, mac_base's 3) on mac_cc
template <class Fd>
struct Sum;
template <>
struct Sum<GLF> {
  static __device__ __forceinline__ void mac(gl::Wide& w, uint64_t a,
                                             uint64_t z) {
    mac_cc(w, a, z);
  }
  static __device__ __forceinline__ void mac_base(gl::Wide& w, uint64_t z,
                                                  uint64_t b) {
    mac_cc(w, z, b);
  }
};
template <>
struct Sum<GL3F> {
  static __device__ __forceinline__ void mac(gl3::W3& w, const gl3::E& a,
                                             const gl3::Dbl& b) {
    mac_cc(w.c0, a.c0, b.v.c0);
    mac_cc(w.c0, a.c1, b.d2);
    mac_cc(w.c0, a.c2, b.d1);
    mac_cc(w.c1, a.c0, b.v.c1);
    mac_cc(w.c1, a.c1, b.v.c0);
    mac_cc(w.c1, a.c2, b.d2);
    mac_cc(w.c2, a.c0, b.v.c2);
    mac_cc(w.c2, a.c1, b.v.c1);
    mac_cc(w.c2, a.c2, b.v.c0);
  }
  static __device__ __forceinline__ void mac_base(gl3::W3& w,
                                                  const gl3::Dbl& z,
                                                  uint64_t b) {
    mac_cc(w.c0, z.v.c0, b);
    mac_cc(w.c1, z.v.c1, b);
    mac_cc(w.c2, z.v.c2, b);
  }
};

// the prepared a_j of a term in shared memory: GL one u64; GF(p^3) five
// (c0, c1, c2, 2 c1, 2 c2: gl3::Dbl, the form gl3::mac takes)
template <class Fd>
struct Coef;
template <>
struct Coef<GLF> {
  static constexpr int U = 1;
  static __device__ __forceinline__ GLF::D load(const uint64_t* p) {
    return p[0];
  }
};
template <>
struct Coef<GL3F> {
  static constexpr int U = 5;
  static __device__ __forceinline__ GL3F::D load(const uint64_t* p) {
    return {{p[0], p[1], p[2]}, p[3], p[4]};
  }
};

// an extension column's row from its slots (W / 2 of them, `apart` words
// apart)
template <class Fd>
__device__ __forceinline__ typename Fd::E slots_ld(const uint64_t* p,
                                                   int apart);
template <>
__device__ __forceinline__ GLF::E slots_ld<GLF>(const uint64_t* p, int) {
  return p[0];
}
template <>
__device__ __forceinline__ GL3F::E slots_ld<GL3F>(const uint64_t* p,
                                                  int apart) {
  return {p[0], p[apart], p[2 * apart]};
}

// the slot of column c: base columns one, extension columns W / 2
__device__ __forceinline__ int slot_of(int c, int nbase, int H) {
  return c < nbase ? c : nbase + (c - nbase) * H;
}

// meta (int64): column pointers [ncols] (the first nbase base-field),
// column row strides in words [ncols], each term's column [T], each
// point's first term [K + 1], each point's row shift [K] and inverse table
// (0: u, 1: v) [K]; vals (u32 words): a_j prepared [T] (Coef), then C_k
// [K]; u, v: [n, W] words.  Thread t takes rows i0 + r THREADS, r <
// ROWS, of its block's BLOCK_ROWS (a row past n is read at i & (n - 1)
// and not stored).
template <class Fd>
__global__ void __launch_bounds__(THREADS)
deep_kernel(const long long* __restrict__ meta, int ncols, int nbase, int T,
            int K, const uint32_t* __restrict__ vals,
            const uint32_t* __restrict__ u, const uint32_t* __restrict__ v,
            uint32_t n, uint32_t* __restrict__ out) {
  using E = typename Fd::E;
  using A = typename Fd::A;
  constexpr int H = Fd::W / 2, U = Coef<Fd>::U;
  constexpr int ROWS = rows_of<Fd>(), BLOCK_ROWS = THREADS * ROWS;
  extern __shared__ uint64_t smem[];
  const int slots = nbase + (ncols - nbase) * H;
  uint64_t* row_vals = smem;                       // [slots][BLOCK_ROWS]
  uint64_t* coef = row_vals + slots * BLOCK_ROWS;  // [T][U]
  uint64_t* cons = coef + T * U;                   // [K][H]
  int* term_slot = reinterpret_cast<int*>(cons + K * H);   // [T], -1 - slot
  int* first = term_slot + T;                      // [K + 1]
  uint32_t* shift = reinterpret_cast<uint32_t*>(first + K + 1);  // [K]
  int* tab = reinterpret_cast<int*>(shift + K);    // [K]
  const long long* term_col = meta + 2 * ncols;
  const long long* mfirst = term_col + T;
  const long long* mshift = mfirst + K + 1;
  const long long* mtab = mshift + K;
  const uint64_t* v64 = reinterpret_cast<const uint64_t*>(vals);
  const int t = threadIdx.x;
  // the tables, once a block; a base term's slot is kept as -1 - slot
  for (int j = t; j < T * U; j += THREADS) coef[j] = v64[j];
  for (int j = t; j < K * H; j += THREADS) cons[j] = v64[T * U + j];
  for (int j = t; j < T; j += THREADS) {
    const int c = (int)term_col[j];
    const int sl = slot_of(c, nbase, H);
    term_slot[j] = c < nbase ? -1 - sl : sl;
  }
  for (int k = t; k <= K; k += THREADS) first[k] = (int)mfirst[k];
  for (int k = t; k < K; k += THREADS) {
    shift[k] = (uint32_t)mshift[k];
    tab[k] = (int)mtab[k];
  }
  const uint32_t nmask = n - 1;
  const uint32_t i0 = blockIdx.x * BLOCK_ROWS + t;
  // each row of each column, read once: a base column's c0 word, an
  // extension column's coordinates; ROW_LOADS columns' loads in flight
  // before their stores to shared memory
#pragma unroll
  for (int r = 0; r < ROWS; r++) {
    const uint32_t i = (i0 + r * THREADS) & nmask;
#pragma unroll 1
    for (int c0 = 0; c0 < ncols; c0 += ROW_LOADS) {
      uint64_t w[ROW_LOADS][H];
#pragma unroll
      for (int q = 0; q < ROW_LOADS; q++) {
        const int c = c0 + q;
        if (c >= ncols) continue;
        const uint64_t* col = reinterpret_cast<const uint64_t*>(meta[c]) +
                              (i * (uint32_t)meta[ncols + c]) / 2;
#pragma unroll
        for (int h = 0; h < H; h++)
          if (h == 0 || c >= nbase) w[q][h] = col[h];
      }
#pragma unroll
      for (int q = 0; q < ROW_LOADS; q++) {
        const int c = c0 + q;
        if (c >= ncols) continue;
        uint64_t* at = row_vals + slot_of(c, nbase, H) * BLOCK_ROWS +
                       r * THREADS + t;
#pragma unroll
        for (int h = 0; h < H; h++)
          if (h == 0 || c >= nbase) at[h * BLOCK_ROWS] = w[q][h];
      }
    }
  }
  __syncthreads();
  const uint64_t* mine = row_vals + t;
  A row[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; r++) row[r] = Fd::a_zero();
#pragma unroll 1
  for (int k = 0; k < K; k++) {
    // the point's inverses, loaded ahead of its terms (from L2, mostly)
    E x[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; r++) {
      const uint32_t i = i0 + r * THREADS;
      x[r] = tab[k] ? Fd::load(v + (i & nmask) * Fd::W)
                    : Fd::load(u + ((i - shift[k]) & nmask) * Fd::W);
    }
    A s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; r++) s[r] = Fd::a_zero();
    const int j1 = first[k + 1];
#pragma unroll 1
    for (int j = first[k]; j < j1; j++) {
      const int sl = term_slot[j];
      const typename Fd::D a = Coef<Fd>::load(coef + j * U);
      if (sl < 0) {
#pragma unroll
        for (int r = 0; r < ROWS; r++)
          Sum<Fd>::mac_base(s[r], a,
                            mine[(-1 - sl) * BLOCK_ROWS + r * THREADS]);
      } else {
#pragma unroll
        for (int r = 0; r < ROWS; r++)
          Sum<Fd>::mac(s[r],
                       slots_ld<Fd>(mine + sl * BLOCK_ROWS + r * THREADS,
                                    BLOCK_ROWS),
                       a);
      }
    }
    const E C = Fd::load(reinterpret_cast<const uint32_t*>(cons + k * H));
#pragma unroll
    for (int r = 0; r < ROWS; r++)
      Sum<Fd>::mac(row[r], Fd::sub(Fd::reduce(s[r]), C), Fd::prep(x[r]));
  }
#pragma unroll
  for (int r = 0; r < ROWS; r++) {
    const uint32_t i = i0 + r * THREADS;
    if (i < n) Fd::store(out + i * Fd::W, Fd::reduce(row[r]));
  }
}

template <class Fd>
int launch(const void* meta, const void* vals, const void* u, const void* v,
           int ncols, int nbase, int T, int K, long long n, void* out,
           cudaStream_t s) {
  constexpr int H = Fd::W / 2, BLOCK_ROWS = THREADS * rows_of<Fd>();
  const size_t bytes =
      8 * ((size_t)(nbase + (ncols - nbase) * H) * BLOCK_ROWS +
           (size_t)T * Coef<Fd>::U + (size_t)K * H) +
      4 * ((size_t)T + (K + 1) + 2 * (size_t)K);
  const cudaError_t e = cudaFuncSetAttribute(
      deep_kernel<Fd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  deep_kernel<Fd><<<(unsigned)((n + BLOCK_ROWS - 1) / BLOCK_ROWS), THREADS,
                    bytes, s>>>((const long long*)meta, ncols, nbase, T, K,
                                (const uint32_t*)vals, (const uint32_t*)u,
                                (const uint32_t*)v, (uint32_t)n,
                                (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// u, v, out: [n, L] words (L = 2: GL, 6: GF(p^3)), n a power of two with
// n L < 2^32; meta and vals on the device as above, the first nbase
// columns base-field values (over GL every column is one word: nbase is
// read as given and changes nothing)
extern "C" int gl_deep_compose(const void* meta, const void* vals,
                               const void* u, const void* v, int ncols,
                               int nbase, int T, int K, long long n, int L,
                               void* out, void* stream) {
  if ((L != 2 && L != 6) || nbase < 0 || nbase > ncols)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && K > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    return L == 2 ? launch<GLF>(meta, vals, u, v, ncols, nbase, T, K, n, out,
                                s)
                  : launch<GL3F>(meta, vals, u, v, ncols, nbase, T, K, n,
                                 out, s);
  }
  return (int)cudaGetLastError();
}
