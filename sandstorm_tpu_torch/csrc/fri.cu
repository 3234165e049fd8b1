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
// N / 2) times the stage's scalar beta_s = (beta c^-1)^(2^s), which the
// host forms (stark/fri.py) and the launch passes by value.  Output i
// depends only on the inputs i + k N / f, k < f; halving s pairs k with
// k + f / 2^(s + 1), and its multiplier for pair k, xinv[(i + k N / f)
// 2^s], is the square of halving s - 1's.  Over GF(p^3) the table is
// Goldilocks' own (one u64 a row) and enters as 3 Goldilocks products
// (GL3F::scale), the scalar as one GF(p^3) product; every result is
// canonical, so the words are the plain chain's.
//
// What bounds it on the H100: at the wide layers (a prove's first one or
// two) the products and device memory together (starknet's Fp252 layer
// 0: 218 MB, 14 montmuls an output); at the small ones the launch's
// latency: a thread an output leaves 2^13 outputs on a tenth of the card.
// The design (PERF.md):
// - the table is read at halving 0 only, f / 2 rows an output, coalesced
//   across the warp: over Fp252 and GL the pair's multiplier becomes
//   x^-1 beta_0 and each later halving's its square, x^-(2^s) beta_s (one
//   product and a square a pair where the table took two products); over
//   GF(p^3) the base-field x^-1 is squared (one Goldilocks product).  The
//   GF(p^3) thread form alone reads the table at every halving (on the
//   H100 the faster there);
// - the entry picks the form from M, f and the SM count (fold_lanes;
//   fields/field_cuda.py fold_lanes mirrors it): a wide layer (M above
//   LANE_THREADS an SM) takes a thread an output; a small one the most
//   lanes an output, up to f / 2, that keep its M x lanes threads within
//   LANE_THREADS an SM.  Lane j of an output holds its inputs k = j mod
//   lanes and folds its pairs in registers while they lie in the lane,
//   then pairs with lane j + h by a shuffle, a warp taking 32 / lanes
//   outputs (lane j of them on consecutive rows): f / 2 lanes give f / 2
//   times the threads and a dependent chain of S halvings, not f - 1;
// - blocks of 32 to 256 threads, the most that still give every SM one;
//   the GL and GF(p^3) thread forms name a minimum of blocks an SM (on
//   the H100 4-8% faster over GL and at the parent's time over GF(p^3),
//   where 256-thread blocks without it lost 1-4%, PERF.md).
// One template serves the three fields (fp252.cuh's FPF, goldilocks.cuh's
// GLF and GL3F).
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

#include "fp252.cuh"
#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_STAGES = 4;   // f up to 16 (FOLD_MAX_STAGES, field_cuda.py)
// a small layer's threads an SM (FOLD_LANE_THREADS, field_cuda.py)
constexpr long long LANE_THREADS = 128;

// the stages' scalars, an element of W words each, stage s from word s W
struct Scalars {
  uint32_t w[MAX_STAGES * 8];
};

__device__ __forceinline__ fp::F square(const fp::F& x) { return fp::sqr(x); }
__device__ __forceinline__ uint64_t square(uint64_t x) {
  return gl::mul(x, x);
}

// v of the lane d above (every lane of the warp calls it)
__device__ __forceinline__ fp::F shfl_down(const fp::F& v, int d) {
  fp::F o;
#pragma unroll
  for (int k = 0; k < 8; k++) o.v[k] = __shfl_down_sync(0xffffffffu, v.v[k], d);
  return o;
}
__device__ __forceinline__ uint64_t shfl_down(uint64_t v, int d) {
  return __shfl_down_sync(0xffffffffu, (unsigned long long)v, d);
}
__device__ __forceinline__ gl3::E shfl_down(const gl3::E& v, int d) {
  return {shfl_down(v.c0, d), shfl_down(v.c1, d), shfl_down(v.c2, d)};
}

// one pair of a halving: (u + w) + (u - w) x beta
template <class Fd>
__device__ __forceinline__ typename Fd::E halve(const typename Fd::E& u,
                                                const typename Fd::E& w,
                                                const typename Fd::X& x,
                                                const typename Fd::E& beta) {
  return Fd::add(Fd::add(u, w), Fd::mul(Fd::scale(Fd::sub(u, w), x), beta));
}

// A lane's share of output i: inputs k = j + LO c (c < K), the rows
// i + k M; zeros past M
template <class Fd, int K, int LO, bool GUARD>
__device__ __forceinline__ void load_lane(const uint32_t* __restrict__ x,
                                          long long M, long long i, int j,
                                          typename Fd::E (&v)[K]) {
  const bool live = !GUARD || i < M;
#pragma unroll
  for (int c = 0; c < K; c++)
    v[c] = live ? Fd::load(x + (i + (j + LO * c) * M) * Fd::W) : Fd::zero();
}

// Halving s of the pair (u, w) whose multiplier m holds the table's x^-1
// at halving 0 and what halving s - 1 left in it after.  SQ over a base
// field (Fp252, GL): m becomes x^-1 beta_0 at halving 0 and its square
// at each later one, x^-(2^s) beta_s (beta_s = beta_0^(2^s)), so a pair
// takes one product and a square; SQ over GF(p^3): m, a base-field value,
// is squared, and the pair takes the base product and the one by beta_s;
// else (the table read at every halving) m is the table's at halving s.
template <class Fd, bool SQ>
__device__ __forceinline__ typename Fd::E step(const typename Fd::E& u,
                                               const typename Fd::E& w,
                                               typename Fd::X& m, int s,
                                               const typename Fd::E& beta) {
  if constexpr (SQ && std::is_same_v<typename Fd::E, typename Fd::X>) {
    m = s == 0 ? Fd::mul(m, beta) : square(m);
    return Fd::add(Fd::add(u, w), Fd::mul(Fd::sub(u, w), m));
  } else {
    if (SQ && s > 0) m = square(m);
    return halve<Fd>(u, w, m, beta);
  }
}

// every halving of output i's share in lane j (the fold's result in c[0]
// of lane j = 0): while h >= LO the pairs (k, k + h) lie in the lane, c
// and c + h / LO; then lane j takes lane j + h's value by a shuffle.
// Halving 0's multiplier of the lane's pair q is the table's row at m0 +
// q mstep (row i + (j + LO q) M), read where the pair is folded; later
// ones from the table too where !SQ.
template <class Fd, int S, int LG, bool SQ, bool GUARD>
__device__ __forceinline__ void fold_lane(
    typename Fd::E (&c)[(1 << S) >> LG], const uint32_t* m0, long long mstep,
    const uint32_t* __restrict__ xinv, long long xs, const Scalars& sc,
    long long M, long long i, int j) {
  using E = typename Fd::E;
  using X = typename Fd::X;
  constexpr int f = 1 << S, LO = 1 << LG, O = 32 / LO, K = f / LO;
  X m[K / 2];
#pragma unroll
  for (int s = 0; s < S; s++) {
    const E beta = Fd::from_words(sc.w + s * Fd::W);
    const int h = f >> (s + 1);
    if (h >= LO) {
#pragma unroll
      for (int q = 0; q < K / 2; q++) {
        if (q < h / LO && (!GUARD || i < M)) {
          if (s == 0)
            m[q] = Fd::load_x(m0 + q * mstep);
          else if (!SQ)
            m[q] = Fd::load_x(xinv + ((i + (j + LO * q) * M) << s) * xs);
          c[q] = step<Fd, SQ>(c[q], c[q + h / LO], m[q], s, beta);
        }
      }
    } else {
      const E w = shfl_down(c[0], h * O);
      if (j < h && (!GUARD || i < M)) {
        if (!SQ) m[0] = Fd::load_x(xinv + ((i + j * M) << s) * xs);
        c[0] = step<Fd, SQ>(c[0], w, m[0], s, beta);
      }
    }
  }
}

// The fold: an output across LO = 2^LG lanes, a warp taking 32 / LO
// outputs (lane o + j (32 / LO) holds output o's inputs k = j mod LO);
// a thread an output (LG = 0) leaves past M at once, as no shuffle needs
// it
template <class Fd, int S, int LG, bool SQ>
__device__ __forceinline__ void fold_body(
    const uint32_t* __restrict__ x, const uint32_t* __restrict__ xinv,
    long long xs, const Scalars& sc, long long M, uint32_t* __restrict__ out) {
  using E = typename Fd::E;
  constexpr int LO = 1 << LG, O = 32 / LO, K = (1 << S) / LO;
  const int lane = threadIdx.x & 31, j = lane / O, o = lane % O;
  const long long i =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32 * O + o;
  if (LG == 0 ? i >= M : i - o >= M) return;
  E v[K];
  load_lane<Fd, K, LO, LG != 0>(x, M, i, j, v);
  fold_lane<Fd, S, LG, SQ, LG != 0>(v, xinv + (i + j * M) * xs,
                                    (long long)LO * M * xs, xinv, xs, sc, M,
                                    i, j);
  if (j == 0 && i < M) Fd::store(out + i * Fd::W, v[0]);
}

// the GF(p^3) thread form reads the table at every halving; every other
// form squares its multipliers
template <class Fd, int LG>
constexpr bool kSquares = LG > 0 || !std::is_same_v<Fd, GL3F>;

template <class Fd, int S, int LG>
__global__ void __launch_bounds__(THREADS)
fold_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ xinv,
            long long xs, const __grid_constant__ Scalars sc, long long M,
            uint32_t* __restrict__ out) {
  fold_body<Fd, S, LG, kSquares<Fd, LG>>(x, xinv, xs, sc, M, out);
}

// the Goldilocks and GF(p^3) thread forms, MINB blocks an SM named (3
// over GF(p^3), 2 over GL: ptxas then schedules them the faster way on an
// H100, PERF.md).  Naming a minimum for the Fp252 thread form, even 1,
// made ptxas give it 128-149 registers for 99 and cost it 3-5%.
template <class Fd, int S, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
fold_kernel_occ(const uint32_t* __restrict__ x,
                const uint32_t* __restrict__ xinv, long long xs,
                const __grid_constant__ Scalars sc, long long M,
                uint32_t* __restrict__ out) {
  fold_body<Fd, S, 0, kSquares<Fd, 0>>(x, xinv, xs, sc, M, out);
}

// log2 of the lanes an output for M outputs of a fold by 2^S on `sms` SMs
// (fold_lanes in fields/field_cuda.py): 0 past LANE_THREADS an SM, else
// the most, below S, that keep M x lanes within it
int fold_lanes(long long M, int S, int sms) {
  const long long cap = LANE_THREADS * sms;
  int lg = 0;
  if (M <= cap)
    while (lg + 1 < S && (M << (lg + 1)) <= cap) lg++;
  return lg;
}

template <class Fd, int S, int LG>
void launch_lanes(const uint32_t* x, const uint32_t* xinv, long long xs,
                  const Scalars& sc, long long M, int sms, uint32_t* out,
                  cudaStream_t stream) {
  constexpr int O = 32 >> LG;
  const long long threads = (M + O - 1) / O * 32;
  // blocks of 32 to THREADS threads, the most that still give every SM
  // a block: a small layer spreads over the card
  int bt = THREADS;
  while (bt > 32 && threads < (long long)bt * sms) bt >>= 1;
  const unsigned blocks = (unsigned)((threads + bt - 1) / bt);
  if constexpr (Fd::W != 8 && LG == 0)
    fold_kernel_occ<Fd, S, Fd::W == 6 ? 3 : 2><<<blocks, bt, 0, stream>>>(
        x, xinv, xs, sc, M, out);
  else
    fold_kernel<Fd, S, LG><<<blocks, bt, 0, stream>>>(x, xinv, xs, sc, M,
                                                      out);
}

template <class Fd, int S>
void launch_stages(const uint32_t* x, const uint32_t* xinv, long long xs,
                   const Scalars& sc, long long M, uint32_t* out,
                   cudaStream_t stream) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int lg = fold_lanes(M, S, sms);
  if (lg == 0) launch_lanes<Fd, S, 0>(x, xinv, xs, sc, M, sms, out, stream);
  if constexpr (S > 1)
    if (lg == 1) launch_lanes<Fd, S, 1>(x, xinv, xs, sc, M, sms, out, stream);
  if constexpr (S > 2)
    if (lg == 2) launch_lanes<Fd, S, 2>(x, xinv, xs, sc, M, sms, out, stream);
  if constexpr (S > 3)
    if (lg == 3) launch_lanes<Fd, S, 3>(x, xinv, xs, sc, M, sms, out, stream);
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
    const uint32_t* xp = (const uint32_t*)x;
    const uint32_t* tp = (const uint32_t*)xinv;
    uint32_t* op = (uint32_t*)out;
    switch (stages) {
      case 1: launch_stages<Fd, 1>(xp, tp, xs, sc, M, op, s); break;
      case 2: launch_stages<Fd, 2>(xp, tp, xs, sc, M, op, s); break;
      case 3: launch_stages<Fd, 3>(xp, tp, xs, sc, M, op, s); break;
      default: launch_stages<Fd, 4>(xp, tp, xs, sc, M, op, s); break;
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
