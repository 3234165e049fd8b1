// Kernel deep_compose: the DEEP composition's numerator and denominator at
// every row of the LDE domain, as one fraction.
//
// Replaces the JAX package's DEEP dispatches, sandstorm_tpu/stark/
// prover.py:488 _deep_den_fwd and :498 _deep_den_bwd (two lax.scans along
// the points axis, under :509 _deep_den_scans: every 1 / (x - pt_k) of a
// window as a [K, B] stack) and :527 _deep_apply_point / :539
// _deep_apply_group (the points' terms, eight points to a fused dispatch).
// For each row x, with the terms grouped by point as the transcript orders
// them:
//     N_k = sum_{j of point k} c_j (T_j(x) - t_j),  d_k = x - pt_k,
//     (num, den) <- (num d_k + N_k den, den d_k)   over k = 0 .. K-1,
// so num / den = sum_k N_k / d_k, the JAX package's sum, with no [K, B]
// stack: one batch inversion of den over the domain and one multiply finish
// it (stark/prover.py deep_compose).
//
// Bound on the H100: operations.  T + 3K - 2 montmuls a row (starknet: 273
// terms on 192 points, 847) against (T_cols + 1) * 32 bytes in and 64 out.
// Design: one thread a row, num, den and the point's sum in registers; the
// per-term and per-point scalars (t_j, c_j, pt_k) and the term table are
// the same for every thread, so a warp reads each as one broadcast through
// L1; a row's column values are read where their terms are, once each term
// (a column named at several points is read again, from L1/L2).
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

constexpr int THREADS = 128;

// meta (int64): column pointers [ncols], column row strides in words
// [ncols], each term's column [T], each point's first term [K + 1];
// vals: t_j [T], c_j [T], pt_k [K] as Montgomery elements
__global__ void __launch_bounds__(THREADS)
deep_kernel(const long long* __restrict__ meta, int ncols, int T, int K,
            const uint32_t* __restrict__ vals,
            const uint32_t* __restrict__ domain, long long n,
            uint32_t* __restrict__ num_out, uint32_t* __restrict__ den_out) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long* strides = meta + ncols;
  const long long* term_col = meta + 2 * ncols;
  const long long* first = term_col + T;
  const fp::F x = fp::load(domain + i * 8);
  fp::F num = fp::zero(), den = fp::zero();
#pragma unroll 1
  for (int k = 0; k < K; k++) {
    fp::F nk = fp::zero();
    const int j1 = (int)first[k + 1];
#pragma unroll 1
    for (int j = (int)first[k]; j < j1; j++) {
      const int c = (int)term_col[j];
      const uint32_t* col = reinterpret_cast<const uint32_t*>(meta[c]);
      const fp::F v = fp::load(col + i * strides[c]);
      nk = fp::add(nk, fp::mul(fp::sub(v, fp::load(vals + j * 8)),
                               fp::load(vals + (T + j) * 8)));
    }
    const fp::F d = fp::sub(x, fp::load(vals + (2 * T + k) * 8));
    if (k == 0) {
      num = nk;
      den = d;
    } else {
      num = fp::add(fp::mul(num, d), fp::mul(nk, den));
      den = fp::mul(den, d);
    }
  }
  fp::store(num_out + i * 8, num);
  fp::store(den_out + i * 8, den);
}

}  // namespace

// domain, num, den: [n, 8] words; meta and vals on the device as above
extern "C" int deep_compose(const void* meta, const void* vals,
                            const void* domain, int ncols, int T, int K,
                            long long n, void* num, void* den, void* stream) {
  if (n > 0 && K > 0) {
    deep_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                  (cudaStream_t)stream>>>(
        (const long long*)meta, ncols, T, K, (const uint32_t*)vals,
        (const uint32_t*)domain, n, (uint32_t*)num, (uint32_t*)den);
  }
  return (int)cudaGetLastError();
}
