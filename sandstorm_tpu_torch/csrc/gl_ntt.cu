// The Goldilocks NTT leaf -- every radix-2 DIT stage of a batch of length-M
// Goldilocks transforms -- and its fused form, the first leaf of a four-step.
//
// Replaces sandstorm_tpu/ntt/ntt_pallas.py:_mk_ntt_kernel("goldilocks")
// (:58, run by _ntt_leaf_call :101, butterflies from fields/gl_pallas.py
// gl_mul_tile / gl_add_tile / gl_sub_tile).  Every GL and GF(p^3)
// transform of the port runs through it: a GF(p^3) column is three GL
// columns on the batch axis (ntt/ntt.py).  The TPU kernel held a
// [2, M, 128] (lo, hi) block in VMEM with M <= 256; here M <= 2048 is
// capped by the block's shared-memory tile.
//
// Layout: x is [M, Bt, 2] u32 (row m, transform j, lo/hi), natural order.
// gl_ntt_leaf writes out [M, Bt, 2] in natural order.  gl_ntt_leaf_fused,
// for the four-step of ntt/ntt_cuda.py with transform j = c * Bi + b
// (c < C = Bt / Bi), multiplies output k by rc[k, c] = w^(k c) (rc is
// [M, C, 2]) and stores it transposed, at out[c, k, b] of a [C, M, Bi, 2]
// array: the twiddle multiply and the transpose copy of the four-step are
// its epilogue.  tw is the [M/2, 2] table of w_M^k (canonical); stage s
// reads w_M^((M >> s) * j).
//
// Bound on the H100: device memory by the count of bytes and multiplies
// (16 B per element in and out against log2 M / 2 Goldilocks multiplies),
// but the butterfly of plain-C 64-bit arithmetic compiles to some 50
// machine operations, so at M = 2048 the kernel is held by the rate at
// which an SM dispatches them.  Design:
//  - a block owns a tile of G = 8192 / M adjacent transforms, not one, so a
//    row of the tile is G x 8 contiguous bytes (a whole 32-byte sector at
//    M = 2048, 64 bytes at M = 1024) and every load and store moves whole
//    sectors; lanes of a warp run over the tile's transforms first;
//  - register stages: a thread holds E = 16 elements (u64 each) and runs
//    four radix-2 stages on them between exchanges, so an M = 2048
//    transform takes three register phases and two exchanges;
//  - the exchange is in place: each phase's slots in shared memory belong
//    to one thread, which writes them after its stages and reads the next
//    phase's after one barrier; slots are swizzled so that both patterns
//    (element strides 1 and 16) are free of bank conflicts;
//  - the first phase reads its elements straight from device memory (rows
//    in bit-reversed order) and the last writes straight to it, so data
//    crosses shared memory only between phases;
//  - the stage twiddles are staged in shared memory once per block, stage
//    s at [2^(s-1), 2^s), so threads on consecutive butterflies read
//    consecutive words; blocks are persistent and walk over the tiles;
//  - fewer operations a butterfly: the first phase is compiled apart
//    (its twiddle indices are constants: no branch, no multiply by 1), and
//    between stages an element is any u64 representative of its value, so
//    an add needs one correction and a multiply's two fold into one; the
//    last phase's store canonicalises.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int LOG_M_MAX = 11;
constexpr int LOG_THREADS = 9;
constexpr int THREADS = 1 << LOG_THREADS;
constexpr int LOGE_MAX = 4;    // a thread holds 16 elements
constexpr int MIN_BLOCKS = 2;  // blocks an SM, caps the registers at 64

// slot of element i: the low LOGE bits are XORed with the next LOGE, so
// threads whose elements lie 2^LOGE apart (the first phase's pattern) hit
// distinct banks, as threads on consecutive elements do.  Linear over XOR:
// swz(a | b) = swz(a) ^ swz(b) for disjoint a, b.
template <int LOGE>
__device__ __forceinline__ int swz(int i) {
  return i ^ ((i >> LOGE) & ((1 << LOGE) - 1));
}

// In the phase that runs stages s0 + 1 .. s0 + k, slot q of thread t holds
// element base(t) | qoff(q): q's low k bits are the position among the 2^k
// elements the stages combine (index bits s0 .. s0 + k - 1); t fills the
// other index bits from the lowest up; where k < LOGE (a short last phase,
// s0 + k = log2 M) t has fewer than s0 bits and q's high bits fill the
// rest of the low s0, from bit log2 M - LOGE.
__device__ __forceinline__ int base_of(int t, int s0, int k) {
  return ((t >> s0) << (s0 + k)) | (t & ((1 << s0) - 1));
}

template <int LOGE>
__device__ __forceinline__ int qoff(int q, int s0, int k, int logM) {
  return ((q & ((1 << k) - 1)) << s0) | ((q >> k) << (logM - LOGE));
}


// Between stages an element is any u64 representative of its value
// ("loose": below 2^64, not below p), and the last phase's store
// canonicalises it: the sum of a loose a and a canonical b needs one
// correction, not two.  gl::sub already takes a loose minuend.
__device__ __forceinline__ uint64_t add_loose(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += gl::EPS;  // carry out: 2^64 = 2^32 - 1; b < p, so at
  return s;                 // most 2^64 - 2 and no second carry
}

// a * b mod p, canonical, for a loose a and a canonical b: gl::mul with its
// two corrections folded into one.  lo + w2 (2^32 - 1) - w3 as a 128-bit
// sum has a high half k of 0, 1 or -1 (2^64 times k is k (2^32 - 1)
// mod p); adding k (2^32 - 1) to the low half cannot wrap: after a carry
// the low half is at most 2^64 - 2^33, after a borrow at least
// 2^64 - 2^32 + 1.
__device__ __forceinline__ uint64_t mul_loose(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t w2 = hi & 0xFFFFFFFFull, w3 = hi >> 32;
  const unsigned __int128 s = (unsigned __int128)lo + w2 * gl::EPS - w3;
  const uint64_t k = (uint64_t)(s >> 64);
  return gl::cond_sub_p((uint64_t)s + (k << 32) - k);
}

// Stages s0 + 1 .. s0 + k on a thread's E loose elements.  FIRST (s0 = 0,
// k = LOGE): the twiddle index is known at compile time, so offset 0
// (twiddle 1) costs no multiply and no branch; later phases multiply
// throughout.
template <int LOGE, bool FIRST>
__device__ __forceinline__ void stages(uint64_t (&e)[1 << LOGE],
                                       const uint64_t* tws, int s0, int k,
                                       int low, int logM) {
  constexpr int E = 1 << LOGE;
#pragma unroll
  for (int u = 0; u < LOGE; u++) {
    if (!FIRST && u >= k) break;
#pragma unroll
    for (int q0 = 0; q0 < E; q0++) {
      if ((q0 >> u) & 1) continue;
      const int q1 = q0 | (1 << u);
      // stage s0 + u + 1: the pair's offset in its block is the index bits
      // below s0 + u: the low s0 bits (from t, and from q0's high bits in a
      // short last phase) and q0's low u bits
      const int c = (1 << u) | (q0 & ((1 << u) - 1));
      uint64_t v = e[q1];
      if (FIRST) {
        if (c != (1 << u))
          v = mul_loose(v, tws[c]);
        else
          v = gl::cond_sub_p(v);
      } else {
        v = mul_loose(v,
                      tws[(c << s0) | low | ((q0 >> k) << (logM - LOGE))]);
      }
      e[q1] = gl::sub(e[q0], v);
      e[q0] = add_loose(e[q0], v);
    }
  }
}

template <int LOGE, bool FUSED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gl_ntt_leaf_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ rc, int logM, long long Bt,
                   long long Bi) {
  constexpr int E = 1 << LOGE;
  extern __shared__ uint64_t smem[];
  const int M = 1 << logM;
  const int logG = LOG_THREADS - (logM - LOGE);  // log2 transforms a block
  const int G = 1 << logG;
  const int g = threadIdx.x & (G - 1), t = threadIdx.x >> logG;
  const int nphase = (logM + LOGE - 1) / LOGE;
  uint64_t* tws = smem;       // M words: stage s at [2^(s-1), 2^s)
  uint64_t* data = smem + M;  // THREADS * E words (if nphase > 1)

  for (int idx = 1 + threadIdx.x; idx < M; idx += THREADS) {
    const int s = 32 - __clz(idx);
    const int jw = idx - (1 << (s - 1));
    tws[idx] = gl::load(tw + (long long)(jw << (logM - s)) * 2);
  }
  __syncthreads();

  const long long ntiles = (Bt + G - 1) >> logG;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long j = (tile << logG) + g;
    const bool live = j < Bt;
    uint64_t e[E];
    // the first phase (stages 1 .. LOGE), from device memory
    if (live) {
      const int base = base_of(t, 0, LOGE);
#pragma unroll
      for (int q = 0; q < E; q++) {
        const int src = (int)(__brev((unsigned)(base | q)) >> (32 - logM));
        e[q] = gl::load(x + ((long long)src * Bt + j) * 2);
      }
      stages<LOGE, true>(e, tws, 0, LOGE, 0, logM);
      if (nphase > 1) {
        const int sb = swz<LOGE>(base);
#pragma unroll
        for (int q = 0; q < E; q++)
          data[((sb ^ swz<LOGE>(q)) << logG) | g] = e[q];
      }
    }
    for (int p = 1; p < nphase; p++) {
      const int s0 = p * LOGE;
      const int k = logM - s0 < LOGE ? logM - s0 : LOGE;
      __syncthreads();
      if (live) {
        const int base = base_of(t, s0, k);
        const int sb = swz<LOGE>(base);
#pragma unroll
        for (int q = 0; q < E; q++)
          e[q] = data[((sb ^ swz<LOGE>(qoff<LOGE>(q, s0, k, logM))) << logG)
                      | g];
        stages<LOGE, false>(e, tws, s0, k, base & ((1 << s0) - 1), logM);
        if (p + 1 < nphase) {  // k == LOGE here
#pragma unroll
          for (int q = 0; q < E; q++)
            data[((sb ^ swz<LOGE>(qoff<LOGE>(q, s0, k, logM))) << logG) | g] =
                e[q];
        }
      }
    }
    if (live) {
      const int s0 = (nphase - 1) * LOGE;
      const int k = logM - s0;
      const int base = base_of(t, s0, k);
      const long long C = FUSED ? Bt / Bi : 0;
      const long long c = FUSED ? j / Bi : 0;
      const long long b = FUSED ? j - c * Bi : 0;
#pragma unroll
      for (int q = 0; q < E; q++) {
        const int i = base | qoff<LOGE>(q, s0, k, logM);
        if (FUSED) {
          const uint64_t r =
              mul_loose(e[q], gl::load(rc + ((long long)i * C + c) * 2));
          gl::store(out + (((long long)c * M + i) * Bi + b) * 2, r);
        } else {
          gl::store(out + ((long long)i * Bt + j) * 2, gl::cond_sub_p(e[q]));
        }
      }
    }
    // the next tile's first exchange writes slots this one may still read
    if (nphase > 1) __syncthreads();
  }
}

template <int LOGE, bool FUSED>
int launch(const void* x, void* out, const void* tw, const void* rc, int logM,
           long long Bt, long long Bi, cudaStream_t stream) {
  auto kern = gl_ntt_leaf_kernel<LOGE, FUSED>;
  const int M = 1 << logM;
  const int nphase = (logM + LOGE - 1) / LOGE;
  const int smem = (M + (nphase > 1 ? THREADS << LOGE : 0)) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (Bt > 0) {
    int dev, sms, per_sm;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, THREADS, smem)) != cudaSuccess)
      return (int)err;
    const int logG = LOG_THREADS - (logM - LOGE);
    long long blocks = (Bt + (1LL << logG) - 1) >> logG;
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (blocks > resident) blocks = resident;
    kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
        (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw,
        (const uint32_t*)rc, logM, Bt, Bi);
  }
  return (int)cudaGetLastError();
}

template <bool FUSED>
int dispatch(const void* x, void* out, const void* tw, const void* rc,
             int logM, long long Bt, long long Bi, void* stream) {
  if (logM < 1 || logM > LOG_M_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (logM == 1) return launch<1, FUSED>(x, out, tw, rc, logM, Bt, Bi, s);
  if (logM == 2) return launch<2, FUSED>(x, out, tw, rc, logM, Bt, Bi, s);
  if (logM == 3) return launch<3, FUSED>(x, out, tw, rc, logM, Bt, Bi, s);
  return launch<LOGE_MAX, FUSED>(x, out, tw, rc, logM, Bt, Bi, s);
}

}  // namespace

extern "C" int gl_ntt_leaf(const void* x, void* out, const void* tw, int logM,
                           long long B, void* stream) {
  return dispatch<false>(x, out, tw, nullptr, logM, B, 1, stream);
}

extern "C" int gl_ntt_leaf_fused(const void* x, void* out, const void* tw,
                                 const void* rc, int logM, long long Bt,
                                 long long Bi, void* stream) {
  if (Bi < 1 || Bt % Bi) return (int)cudaErrorInvalidValue;
  return dispatch<true>(x, out, tw, rc, logM, Bt, Bi, stream);
}
