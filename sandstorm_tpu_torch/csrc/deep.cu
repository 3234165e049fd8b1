// Kernel deep_compose: the DEEP composition at every row of the LDE domain,
// from the denominators' inverses read at shifted rows.
//
// Replaces the JAX package's DEEP dispatches, sandstorm_tpu/stark/
// prover.py:488 _deep_den_fwd and :498 _deep_den_bwd (two lax.scans along
// the points axis, under :509 _deep_den_scans: every 1 / (x - pt_k) of a
// window as a [K, B] stack) and :527 _deep_apply_point / :539
// _deep_apply_group (the points' terms, eight points to a fused dispatch),
// under :554 _deep_compose.
//
// The LDE domain is x_i = coset w^i in natural order and every trace point
// is z g^o with g = w^b (b the blowup, o taken mod the trace length), so
//     1 / (x_i - z g^o) = g^-o u[(i - o b) mod N],   u = 1 / (x - z),
// and the composition point's inverses are v = 1 / (x - z^m).  The host
// (stark/prover.py deep_compose) inverts u and v in one fp252_batch_inv
// call (csrc/scan.cu), folds g^-o into each term's coefficient,
// a_j = c_j g^-o, and each point's constant into C_k = sum_j a_j t_j; the
// kernel then computes, for each row,
//     D(x_i) = sum_k inv_k(i) (sum_{j of point k} a_j T_j(x_i) - C_k),
// inv_k(i) = u[(i - shift_k) & (N - 1)] for a trace point, v[i] for the
// composition point: T + K products a row (starknet: 271 terms on 192
// points, 463), where the fraction form it replaces took T + 3K plus a
// batch inversion and a multiply of its own.
//
// Bound on the H100: operations, the T + K montmuls' 128 IMAD-pipe issues
// each, against (columns + 3) x 32 bytes a row.  Design: one thread a row;
// a point's terms and the points' products are 512-bit sums with one redc
// each 16 products (fp252.cuh mac_wide), not one each; row indices are
// 32-bit words (the wrapper refuses a domain where they would not fit); a
// term reads its column's row where it needs it: the block's rows of all
// columns (48 KB at starknet's 12) stay in L1 between the terms that name
// them (staging them in shared memory instead, 48 KB a block, capped an SM
// at 4 blocks and ran slower on the H100); the term loop is unrolled by
// two, so two products are in flight; the shifted reads of u fall within
// the offsets' span of rows behind the resident blocks (starknet: 66,316
// rows, 2.1 MB), which L2 holds.  Every product is fp252.cuh's mul_wide
// (aligned pairs, one IMAD.WIDE.U32.X each).
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

constexpr int THREADS = 128;

// meta (int64): column pointers [ncols], column row strides in words
// [ncols], each term's column [T], each point's first term [K + 1], each
// point's row shift [K] and inverse table (0: u, 1: v) [K];
// vals: a_j [T], C_k [K] as Montgomery elements; u, v: [n, 8] words
__global__ void __launch_bounds__(THREADS)
deep_kernel(const long long* __restrict__ meta, int ncols, int T, int K,
            const uint32_t* __restrict__ vals,
            const uint32_t* __restrict__ u, const uint32_t* __restrict__ v,
            uint32_t n, uint32_t* __restrict__ out) {
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long* term_col = meta + 2 * ncols;
  const long long* first = term_col + T;
  const long long* shift = first + K + 1;
  const long long* tab = shift + K;
  const uint32_t nmask = n - 1;
  uint32_t dw[16];
#pragma unroll
  for (int q = 0; q < 16; q++) dw[q] = 0;
  fp::F d = fp::zero();
  int pending = 0;
#pragma unroll 1
  for (int k = 0; k < K; k++) {
    uint32_t s[16];
#pragma unroll
    for (int q = 0; q < 16; q++) s[q] = 0;
    const int j1 = (int)first[k + 1];
#pragma unroll 2
    for (int j = (int)first[k]; j < j1; j++) {
      const int c = (int)term_col[j];
      const uint32_t* col = reinterpret_cast<const uint32_t*>(meta[c]);
      fp::mac_wide(s, fp::load(vals + j * 8),
                   fp::load(col + i * (uint32_t)meta[ncols + c]));
    }
    const fp::F w = fp::sub(fp::redc(s), fp::load(vals + (T + k) * 8));
    const fp::F x = tab[k] ? fp::load(v + i * 8)
                           : fp::load(u + ((i - (uint32_t)shift[k]) & nmask)
                                              * 8);
    fp::mac_wide(dw, w, x);
    if (++pending == fp::WIDE_TERMS) {
      d = fp::add(d, fp::redc(dw));
#pragma unroll
      for (int q = 0; q < 16; q++) dw[q] = 0;
      pending = 0;
    }
  }
  if (pending) d = fp::add(d, fp::redc(dw));
  fp::store(out + i * 8, d);
}

}  // namespace

// u, v, out: [n, 8] words, n a power of two up to 2^29; meta and vals on
// the device as above, every point with 1 to WIDE_TERMS terms
extern "C" int deep_compose(const void* meta, const void* vals,
                            const void* u, const void* v, int ncols, int T,
                            int K, long long n, void* out, void* stream) {
  if (n > 0 && K > 0) {
    deep_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                  (cudaStream_t)stream>>>(
        (const long long*)meta, ncols, T, K, (const uint32_t*)vals,
        (const uint32_t*)u, (const uint32_t*)v, (uint32_t)n, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}
