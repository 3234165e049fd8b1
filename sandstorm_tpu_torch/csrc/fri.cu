// Kernels fp252_fri_fold and gl_fri_fold: one FRI fold of a layer, every
// halving in one launch.
//
// Replaces the XLA routine sandstorm_tpu/stark/fri.py:40 _fold_halvings
// (called by :60 fri_fold_device), which the JAX package jits into one
// dispatch; no Pallas kernel.  The port ran it as five full-width field
// launches a halving (stark/fri.py's plain chain, kept for CPU tensors).
//
// An [N, L] layer in natural order folds by f = 2^S into [N / f, L]: S
// unnormalised halvings with beta, beta^2, beta^4, ..., halving s pairing
// index j with j + N / 2^(s + 1) (x and -x):
//   out[j] = (v[j] + v[j + half]) + (v[j] - v[j + half]) x_j^-1 beta_s
// with x_j^-1 = c^(-2^s) w^(-(2^s) j): the table xinv[(2^s) j] (w^-i, i <
// N / 2) times the stage's scalar c^(-2^s) beta^(2^s), which the host
// forms (stark/fri.py) and the launch passes by value.  Output i depends
// only on the inputs i + k N / f, k < f, so one thread takes one output:
// it reads its f inputs (coalesced across the warp for each k), runs every
// halving in registers and writes once.  Over GF(p^3) the table is
// Goldilocks' own (one u64 a row) and enters as 3 Goldilocks products
// (GL3F::scale), the scalar as one GF(p^3) product; the result is the same
// canonical words as the plain chain's, whose products come in another
// order.
//
// Bound on the H100: device memory at the widest layers (starknet's
// Fp252 layer 0, N = 2^22: 134 MB read, 67 MB of table, 17 MB written)
// and nearly as much by operations (14 montmuls an output at f = 8).
// One template serves the three fields (fp252.cuh's FPF, goldilocks.cuh's
// GLF and GL3F).
#include <cuda_runtime.h>

#include <cstring>

#include "fp252.cuh"
#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_STAGES = 4;   // f up to 16 (FOLD_MAX_STAGES, fp252_cuda.py)

// the stages' scalars, an element of W words each, stage s from word s W
struct Scalars {
  uint32_t w[MAX_STAGES * 8];
};

template <class Fd, int S>
__global__ void __launch_bounds__(THREADS)
fold_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ xinv,
            long long xs, const __grid_constant__ Scalars sc, long long M,
            uint32_t* __restrict__ out) {
  using E = typename Fd::E;
  constexpr int f = 1 << S;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= M) return;
  E v[f];
#pragma unroll
  for (int k = 0; k < f; k++) v[k] = Fd::load(x + (i + k * M) * Fd::W);
#pragma unroll
  for (int s = 0; s < S; s++) {
    const E beta = Fd::from_words(sc.w + s * Fd::W);
    constexpr int top = f >> 1;
    const int h = f >> (s + 1);
#pragma unroll
    for (int k = 0; k < top; k++) {
      if (k < h) {
        const typename Fd::X xi = Fd::load_x(xinv + ((i + k * M) << s) * xs);
        const E d = Fd::sub(v[k], v[k + h]);
        v[k] = Fd::add(Fd::add(v[k], v[k + h]),
                       Fd::mul(Fd::scale(d, xi), beta));
      }
    }
  }
  Fd::store(out + i * Fd::W, v[0]);
}

template <class Fd, int S>
void fold_launch(const void* x, const void* xinv, long long xs,
                 const Scalars& sc, long long M, void* out,
                 cudaStream_t stream) {
  const long long blocks = (M + THREADS - 1) / THREADS;
  fold_kernel<Fd, S><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const uint32_t*)x, (const uint32_t*)xinv, xs, sc, M, (uint32_t*)out);
}

template <class Fd>
int fold_entry(const void* x, const void* xinv, long long xs,
               const void* scalars, int stages, long long M, void* out,
               void* stream) {
  if (stages < 1 || stages > MAX_STAGES || xs < 2) return -1;
  if (M > 0) {
    Scalars sc;
    std::memset(&sc, 0, sizeof sc);
    std::memcpy(sc.w, scalars, sizeof(uint32_t) * Fd::W * stages);
    cudaStream_t s = (cudaStream_t)stream;
    switch (stages) {
      case 1: fold_launch<Fd, 1>(x, xinv, xs, sc, M, out, s); break;
      case 2: fold_launch<Fd, 2>(x, xinv, xs, sc, M, out, s); break;
      case 3: fold_launch<Fd, 3>(x, xinv, xs, sc, M, out, s); break;
      default: fold_launch<Fd, 4>(x, xinv, xs, sc, M, out, s); break;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [N, W] words, N = M 2^stages; xinv: the table w^-i, i < N / 2, an
// entry every xs words whose first words are the multiplier (an Fp252
// element; over Goldilocks and GF(p^3) a Goldilocks value); scalars: a
// host array of `stages` elements (c^(-2^s) beta^(2^s)); out: [M, W]
extern "C" int fp252_fri_fold(const void* x, const void* xinv, long long xs,
                              const void* scalars, int stages, long long M,
                              void* out, void* stream) {
  if (xs < 8) return -1;
  return fold_entry<FPF>(x, xinv, xs, scalars, stages, M, out, stream);
}

// the same for Goldilocks (L = 2) and GF(p^3) (L = 6)
extern "C" int gl_fri_fold(const void* x, const void* xinv, long long xs,
                           const void* scalars, int stages, long long M,
                           int L, void* out, void* stream) {
  if (L == 2)
    return fold_entry<GLF>(x, xinv, xs, scalars, stages, M, out, stream);
  if (L == 6)
    return fold_entry<GL3F>(x, xinv, xs, scalars, stages, M, out, stream);
  return -1;
}
