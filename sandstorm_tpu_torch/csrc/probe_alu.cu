// The ALU-rate probe: R chained operations per element, in registers.
//
// Replaces tools/probe_alu.py:run (pallas_call of mk_kernel :19), which
// measured the TPU vector unit's u32 multiply, add, multiply-add and
// shift-and rates against f32 multiply and FMA on a VMEM-resident
// [256, 128] block, to decide whether a float-based digit multiply could
// beat the integer montmul.  The same question on the H100: the rate of
// 32-bit integer mul / mad against f32 mul / fma.
//
// Bound: the ALU the op runs on; nothing else.  Each thread reads one a and
// one b (from a tile of `tile` elements, which stays in L2), runs R
// dependent ops and writes one word.  Every op is inline PTX (asm
// volatile), so the compiler cannot fold a chain (R adds of b into one
// multiply, R multiplies by b into a power of b).  Enough threads run for
// every SM to hide the chain's latency: the grid is `copies` copies of the
// tile, and copy c of element i writes out[i] (the same value for every c).
//
// ops: 0 u32 mul, 1 u32 add, 2 u32 mul+add (o*b + o), 3 u32 shift+and
// ((o >> 7) & b), 4 f32 mul, 5 f32 fma (fmaf(o, b, o), one rounding).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int R = 256;

template <int OP>
__global__ void probe_kernel(const uint32_t* __restrict__ a,
                             const uint32_t* __restrict__ b,
                             uint32_t* __restrict__ out, int tile,
                             long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int e = (int)(i % tile);
  if (OP < 4) {
    uint32_t o = a[e];
    const uint32_t y = b[e];
#pragma unroll 16
    for (int r = 0; r < R; r++) {
      if (OP == 0) {
        asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(o) : "r"(y));
      } else if (OP == 1) {
        asm volatile("add.u32 %0, %0, %1;" : "+r"(o) : "r"(y));
      } else if (OP == 2) {
        asm volatile("mad.lo.u32 %0, %0, %1, %0;" : "+r"(o) : "r"(y));
      } else {
        asm volatile("shr.u32 %0, %0, 7;\n\tand.b32 %0, %0, %1;"
                     : "+r"(o) : "r"(y));
      }
    }
    out[e] = o;
  } else {
    float o = __uint_as_float(a[e]);
    const float y = __uint_as_float(b[e]);
#pragma unroll 16
    for (int r = 0; r < R; r++) {
      if (OP == 4) {
        asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(o) : "f"(y));
      } else {
        asm volatile("fma.rn.f32 %0, %0, %1, %0;" : "+f"(o) : "f"(y));
      }
    }
    out[e] = __float_as_uint(o);
  }
}

template <int OP>
int launch(const void* a, const void* b, void* out, int tile, long long n,
           void* stream) {
  long long blocks = (n + 255) / 256;
  probe_kernel<OP><<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, tile, n);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: [tile] u32 words (f32 bits for ops 4, 5); n = tile * copies
// threads, n <= 2^31 * 256
extern "C" int probe_alu(const void* a, const void* b, void* out, int op,
                         int tile, long long n, void* stream) {
  if (tile <= 0 || n <= 0 || n % tile) return (int)cudaErrorInvalidValue;
  switch (op) {
    case 0: return launch<0>(a, b, out, tile, n, stream);
    case 1: return launch<1>(a, b, out, tile, n, stream);
    case 2: return launch<2>(a, b, out, tile, n, stream);
    case 3: return launch<3>(a, b, out, tile, n, stream);
    case 4: return launch<4>(a, b, out, tile, n, stream);
    case 5: return launch<5>(a, b, out, tile, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
