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
// (stark/prover.py deep_compose) inverts u and v in one gl_batch_inv call
// (csrc/gl_scan.cu), folds g^-o into each term's coefficient (a_j =
// c_j g^-o, in the extension field over GF(p^3)) and each point's constant
// into C_k = sum_j a_j t_j; the kernel computes, for each row,
//     D(x_i) = sum_k inv_k(i) (sum_{j of point k} a_j T_j(x_i) - C_k),
// inv_k(i) = u[(i - shift_k) & (N - 1)] for a trace point, v[i] for the
// composition point: T + K products a row.
//
// Bound on the H100: a GL product is 8 IMAD-pipe issues, a GF(p^3) product
// 72 (9 GL products); against (columns + 3) x 8 (24) bytes a row, the
// products bound a GF(p^3) prove's DEEP and the bytes a Goldilocks one's.
// Design: one thread a row, every sum reduced as it goes (a GL sum is one
// 64-bit add and a correction), row indices 32-bit words (the wrapper
// refuses a domain where they would not fit); a term reads its column's
// row where it needs it (the block's rows stay in L1 between the terms that
// name them), and the shifted reads of u fall within the offsets' span of
// rows behind the resident blocks, which L2 holds.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 128;

// meta (int64): column pointers [ncols], column row strides in words
// [ncols], each term's column [T], each point's first term [K + 1], each
// point's row shift [K] and inverse table (0: u, 1: v) [K];
// vals: a_j [T], C_k [K]; u, v: [n, W] words
template <class Fd>
__global__ void __launch_bounds__(THREADS)
deep_kernel(const long long* __restrict__ meta, int ncols, int T, int K,
            const uint32_t* __restrict__ vals,
            const uint32_t* __restrict__ u, const uint32_t* __restrict__ v,
            uint32_t n, uint32_t* __restrict__ out) {
  using E = typename Fd::E;
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long* term_col = meta + 2 * ncols;
  const long long* first = term_col + T;
  const long long* shift = first + K + 1;
  const long long* tab = shift + K;
  const uint32_t nmask = n - 1;
  E d = Fd::zero();
#pragma unroll 1
  for (int k = 0; k < K; k++) {
    E s = Fd::zero();
    const int j1 = (int)first[k + 1];
#pragma unroll 2
    for (int j = (int)first[k]; j < j1; j++) {
      const int c = (int)term_col[j];
      const uint32_t* col = reinterpret_cast<const uint32_t*>(meta[c]);
      s = Fd::add(s, Fd::mul(Fd::load(vals + j * Fd::W),
                             Fd::load(col + i * (uint32_t)meta[ncols + c])));
    }
    const E w = Fd::sub(s, Fd::load(vals + (T + k) * Fd::W));
    const E x = tab[k] ? Fd::load(v + i * Fd::W)
                       : Fd::load(u + ((i - (uint32_t)shift[k]) & nmask)
                                          * Fd::W);
    d = Fd::add(d, Fd::mul(w, x));
  }
  Fd::store(out + i * Fd::W, d);
}

template <class Fd>
void launch(const void* meta, const void* vals, const void* u, const void* v,
            int ncols, int T, int K, long long n, void* out,
            cudaStream_t s) {
  deep_kernel<Fd><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      (const long long*)meta, ncols, T, K, (const uint32_t*)vals,
      (const uint32_t*)u, (const uint32_t*)v, (uint32_t)n, (uint32_t*)out);
}

}  // namespace

// u, v, out: [n, L] words (L = 2: GL, 6: GF(p^3)), n a power of two with
// n L < 2^32; meta and vals on the device as above
extern "C" int gl_deep_compose(const void* meta, const void* vals,
                               const void* u, const void* v, int ncols,
                               int T, int K, long long n, int L, void* out,
                               void* stream) {
  if (L != 2 && L != 6) return (int)cudaErrorInvalidValue;
  if (n > 0 && K > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (L == 2)
      launch<GLF>(meta, vals, u, v, ncols, T, K, n, out, s);
    else
      launch<GL3F>(meta, vals, u, v, ncols, T, K, n, out, s);
  }
  return (int)cudaGetLastError();
}
