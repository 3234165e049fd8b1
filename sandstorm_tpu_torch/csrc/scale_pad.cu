// Kernels fp252_scale_pad and gl_scale_pad: the coset scale and zero pad
// before a forward LDE, and the plain scales of a transform's output.
//
// Replaces the XLA routine sandstorm_tpu/stark/prover.py:140 _scale_pad
// (used at :115, :117, :160), which the JAX package jits into one
// dispatch; no Pallas kernel.  The port ran a field multiply, a
// torch.zeros and a full-size torch.cat (ntt/ntt.py's plain version, kept
// for CPU tensors).
//
//   out[i, c] = x[i, c] t[i]   for i < n
//   out[i, c] = 0              for n <= i < N
// over an [n, C] array of elements x (a view: its row and column strides
// in words are arguments; the element's own words contiguous) into a new
// contiguous [N, C] out.  The factor t is an [n] table (the coset powers,
// an entry every ts words) or, with no table, one value passed by value
// (a transform's n^-1).  Over GF(p^3) the factor is a Goldilocks value
// (the coset powers and n^-1 are base-field): one u64 read a row and 3
// Goldilocks products an element (GL3F::scale); the words are F.mul's.
// The pad is canonical zero in each field (all words 0).
//
// Bound on the H100: device memory (each element read once and written,
// the pad written; one product an element).  One thread an output
// element, consecutive threads on consecutive elements, so the loads,
// the table's reads (each entry shared by C neighbours) and the stores
// are coalesced.
#include <cuda_runtime.h>

#include <cstring>

#include "fp252.cuh"
#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;

struct Factor {
  uint32_t w[8];   // the multiplier's words when there is no table
};

template <class Fd>
__global__ void __launch_bounds__(THREADS)
scale_pad_kernel(const uint32_t* __restrict__ x, long long rs, long long cs,
                 long long n, long long C, const uint32_t* __restrict__ t,
                 long long ts, const __grid_constant__ Factor fac,
                 long long total, uint32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
       e < total; e += stride) {
    const long long i = C == 1 ? e : e / C;
    typename Fd::E r = Fd::zero();
    if (i < n) {
      const long long c = e - i * C;
      const typename Fd::X s =
          t ? Fd::load_x(t + i * ts) : Fd::x_from_words(fac.w);
      r = Fd::scale(Fd::load(x + i * rs + c * cs), s);
    }
    Fd::store(out + e * Fd::W, r);
  }
}

template <class Fd>
int scale_pad_entry(const void* x, long long rs, long long cs, long long n,
                    long long C, const void* t, long long ts,
                    const void* factor, long long N, void* out,
                    void* stream) {
  if (n > N || n < 0 || C < 0 || (!t && !factor)) return -1;
  const long long total = N * C;
  if (total > 0) {
    Factor fac;
    std::memset(&fac, 0, sizeof fac);
    if (!t) std::memcpy(fac.w, factor, sizeof(typename Fd::X));
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    scale_pad_kernel<Fd><<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const uint32_t*)x, rs, cs, n, C, (const uint32_t*)t, ts, fac, total,
        (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, C] elements at word offset i rs + c cs; t: the [n] table (an
// entry every ts words, the multiplier its first words) or null, and then
// factor: a host array of the multiplier's words; out: [N, C, W] words
extern "C" int fp252_scale_pad(const void* x, long long rs, long long cs,
                               long long n, long long C, const void* t,
                               long long ts, const void* factor, long long N,
                               void* out, void* stream) {
  return scale_pad_entry<FPF>(x, rs, cs, n, C, t, ts, factor, N, out, stream);
}

// the same for Goldilocks (L = 2) and GF(p^3) (L = 6), the multiplier a
// Goldilocks value (2 words)
extern "C" int gl_scale_pad(const void* x, long long rs, long long cs,
                            long long n, long long C, const void* t,
                            long long ts, const void* factor, long long N,
                            int L, void* out, void* stream) {
  if (L == 2)
    return scale_pad_entry<GLF>(x, rs, cs, n, C, t, ts, factor, N, out,
                                stream);
  if (L == 6)
    return scale_pad_entry<GL3F>(x, rs, cs, n, C, t, ts, factor, N, out,
                                 stream);
  return -1;
}
