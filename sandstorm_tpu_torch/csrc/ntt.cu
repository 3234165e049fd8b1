// Kernel 2: the NTT leaf -- every radix-2 DIT stage of a batch of length-M
// Fp252 transforms -- and its fused form, the first leaf of a four-step.
//
// Replaces sandstorm_tpu/ntt/ntt_pallas.py:_mk_ntt_kernel("fp252") (run by
// _ntt_leaf_call).  The TPU kernel held a [16, M, 128] digit block in VMEM
// with M capped at 256 by its unrolled temporaries; here M <= 2048 is capped
// by shared memory (M elements x 32 B = 64 KB).
//
// Layout: x is [M, Bt, 8] u32 (row m, transform j, limb), natural order.
// ntt_leaf writes out [M, Bt, 8] in natural order.  ntt_leaf_fused, for the
// four-step of ntt/ntt_cuda.py with transform j = c * Bi + b (c < C =
// Bt / Bi), multiplies output k by rc[k, c] = w^(k c) (rc is [M, C, 8]) and
// stores it transposed, at out[c, k, b] of an [C, M, Bi, 8] array: the
// twiddle multiply and the transpose copy of the four-step are its epilogue.
// tw is the [M/2, 8] table of w_M^k (Montgomery); stage s reads
// w_M^((M >> s) * j).
//
// Bound on the H100: the montmuls (one per butterfly whose twiddle is not
// 1), on the IMAD pipe; each element crosses device memory once in and once
// out.  Design against it:
//  - register stages: a thread holds E = 8 elements and runs three radix-2
//    stages on them before exchanging through shared memory, so an M = 2048
//    transform takes four register phases, three exchanges and six
//    barriers;
//  - shared memory element-major in two 16-byte planes, swizzled so that
//    the exchange patterns (element strides 1 and 8) are free of bank
//    conflicts; the stage twiddles are staged there once per block;
//  - blocks are persistent and hold G = 2048 / M transforms each, so short
//    transforms keep 256 threads busy and the twiddles load once per block;
//  - the first phase reads its elements straight from device memory (in
//    bit-reversed order) and the last writes straight to it.
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

constexpr int LOG_M_MAX = 11;
constexpr int THREADS = 256;           // (2048 / 8) threads a block
constexpr int MIN_BLOCKS = 2;          // blocks an SM, caps the registers
constexpr int SLOTS = 1 << LOG_M_MAX;  // elements of shared data a block

// slot of element i inside its plane: the low three bits are XORed with
// bits 3-5, 6-8 and 9-11, so 8 consecutive threads at element strides 1,
// 2, 4, 8, 16, ... hit 8 distinct 16-byte bank groups
__device__ __forceinline__ int swz(int i) {
  return i ^ (((i >> 3) ^ (i >> 6) ^ (i >> 9)) & 7);
}

__device__ __forceinline__ void sput(uint4* plane, int n, int slot,
                                     const fp::F& a) {
  plane[slot] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  plane[n + slot] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ fp::F sget(const uint4* plane, int n, int slot) {
  uint4 x = plane[slot], y = plane[n + slot];
  fp::F r;
  r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  r.v[4] = y.x; r.v[5] = y.y; r.v[6] = y.z; r.v[7] = y.w;
  return r;
}

// element index of slot q of thread t in the phase that runs stages
// s0 + 1 .. s0 + k: q's low k bits pick the position among the 2^k elements
// the stages combine (bits s0 .. s0 + k - 1 of the index); t and q's high
// bits fill the other index bits, t's low bits lowest
template <int LOGE>
__device__ __forceinline__ int elem(int t, int q, int s0, int k, int logM) {
  int f = t | ((q >> k) << (logM - LOGE));
  int lo = f & ((1 << s0) - 1);
  return ((f >> s0) << (s0 + k)) | ((q & ((1 << k) - 1)) << s0) | lo;
}

template <int LOGE, bool FUSED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ntt_leaf_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ rc, int logM, long long Bt,
                long long Bi) {
  constexpr int E = 1 << LOGE;
  extern __shared__ uint4 smem[];
  const int M = 1 << logM;
  const int T = M >> LOGE;              // threads a transform
  const int G = THREADS / T;            // transforms a block
  const int g = threadIdx.x % G, t = threadIdx.x / G;
  const int nphase = (logM + LOGE - 1) / LOGE;
  uint4* data = smem;                   // 2 planes of SLOTS (if nphase > 1)
  uint4* tws = smem + (nphase > 1 ? 2 * SLOTS : 0);  // 2 planes of M / 2

  for (int k = threadIdx.x; k < M / 2; k += THREADS)
    sput(tws, M / 2, swz(k), fp::load(tw + (long long)k * 8));
  __syncthreads();

  for (long long base = (long long)blockIdx.x * G; base < Bt;
       base += (long long)gridDim.x * G) {
    const long long j = base + g;
    const bool live = j < Bt;
    fp::F e[E];
    for (int p = 0; p < nphase; p++) {
      const int s0 = p * LOGE;
      const int k = logM - s0 < LOGE ? logM - s0 : LOGE;
      if (p == 0) {
        if (live) {
#pragma unroll
          for (int q = 0; q < E; q++) {
            int i = elem<LOGE>(t, q, 0, k, logM);
            int src = (int)(__brev((unsigned)i) >> (32 - logM));
            e[q] = fp::load(x + ((long long)src * Bt + j) * 8);
          }
        }
      } else {
        const int ps0 = s0 - LOGE;
        if (live) {
#pragma unroll
          for (int q = 0; q < E; q++)
            sput(data, SLOTS,
                 swz(elem<LOGE>(t, q, ps0, LOGE, logM)) * G + g, e[q]);
        }
        __syncthreads();
        if (live) {
#pragma unroll
          for (int q = 0; q < E; q++)
            e[q] = sget(data, SLOTS,
                        swz(elem<LOGE>(t, q, s0, k, logM)) * G + g);
        }
        __syncthreads();
      }
      if (!live) continue;
#pragma unroll
      for (int u = 0; u < LOGE; u++) {
        if (u >= k) break;
        const int s = s0 + u + 1;  // the stage
#pragma unroll
        for (int q0 = 0; q0 < E; q0++) {
          if ((q0 >> u) & 1) continue;
          const int q1 = q0 | (1 << u);
          fp::F v = e[q1];
          if (s > 1) {
            // the pair's offset in its 2^s block: the index bits below
            // s - 1 of element q0 (equal for slots that differ only above
            // bit u, so the compiler shares the load)
            const int jw =
                elem<LOGE>(t, q0, s0, k, logM) & ((1 << (s - 1)) - 1);
            v = fp::mul(v, sget(tws, M / 2, swz(jw << (logM - s))));
          }
          e[q1] = fp::sub(e[q0], v);
          e[q0] = fp::add(e[q0], v);
        }
      }
    }
    if (!live) continue;
    const int s0 = (nphase - 1) * LOGE;
    const int k = logM - s0;
#pragma unroll
    for (int q = 0; q < E; q++) {
      const int i = elem<LOGE>(t, q, s0, k, logM);
      if (FUSED) {
        const long long C = Bt / Bi, c = j / Bi, b = j % Bi;
        fp::F r = fp::mul(e[q], fp::load(rc + ((long long)i * C + c) * 8));
        fp::store(out + (((long long)c * M + i) * Bi + b) * 8, r);
      } else {
        fp::store(out + ((long long)i * Bt + j) * 8, e[q]);
      }
    }
  }
}

template <int LOGE, bool FUSED>
int launch(const void* x, void* out, const void* tw, const void* rc, int logM,
           long long Bt, long long Bi, cudaStream_t stream) {
  auto kern = ntt_leaf_kernel<LOGE, FUSED>;
  const int M = 1 << logM;
  const int nphase = (logM + LOGE - 1) / LOGE;
  const int smem = (nphase > 1 ? 2 * SLOTS * 16 : 0) + M * 16;
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
    const long long G = THREADS / (M >> LOGE);
    long long blocks = (Bt + G - 1) / G;
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
  return launch<3, FUSED>(x, out, tw, rc, logM, Bt, Bi, s);
}

}  // namespace

extern "C" int ntt_leaf(const void* x, void* out, const void* tw, int logM,
                        long long B, void* stream) {
  return dispatch<false>(x, out, tw, nullptr, logM, B, 1, stream);
}

extern "C" int ntt_leaf_fused(const void* x, void* out, const void* tw,
                              const void* rc, int logM, long long Bt,
                              long long Bi, void* stream) {
  if (Bi < 1 || Bt % Bi) return (int)cudaErrorInvalidValue;
  return dispatch<true>(x, out, tw, rc, logM, Bt, Bi, stream);
}
