// Kernel 5: the Pedersen subset-sum walk, one mixed EC add per window.
//
// Replaces sandstorm_tpu/fields/fp252_pallas.py:ec_madd_digitmajor (body
// _ec_madd_kernel -> _ec_madd_tile): one mixed Jacobian + affine add
// (madd-2007-bl, 7M + 4S), kept where the window value is 0.  The TPU ran one
// madd per pallas_call over digit-major [16, n] blocks and walked the 32
// windows with lax.scan, gathering each window's table rows into HBM in
// between (hashing/pedersen_tpu.py:_hash_pairs_core16).  Here one thread
// carries one hash through the whole walk, so X, Y, Z never leave registers
// from the shift point (Z = 1) to the end and the Jacobian representative is
// the plain walk's, operation for operation.
//
// Bound on the H100: the IMAD pipe (7 products of 64 limb products and 4
// squares of 36 per nonzero window, 32 or 64 windows per hash); the random
// 64-byte row gathers from
// the 128 MB 16-bit table (larger than the 50 MB L2) move about a fifth of
// that time's worth of bytes.  Design against it:
//  - the montmul of fp252.cuh (PTX carry chains, sparse two-step REDC),
//    and its square for the four squarings of each madd;
//  - registers capped by __launch_bounds__ so that two blocks of 256
//    threads share an SM and hide each other's carry-chain latency (the
//    fastest of 2 to 5 blocks of 128 or 256 threads on the H100);
//  - the input limbs held in registers (read once, consumed window by
//    window), and the next nonzero window's row loaded before the current
//    madd starts, so the gather's latency overlaps the arithmetic.
//
// Table: [2 W][2^bits][16] u32, row = x limbs then y limbs of an affine
// point in Montgomery form; windows 0..W-1 belong to input a, W..2W-1 to
// input b, W = 256 / bits.  Entry 0 of each window is never read.
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

constexpr int WALK_THREADS = 256;
constexpr int WALK_MIN_BLOCKS = 2;

__device__ __forceinline__ fp::F dbl(const fp::F& a) { return fp::add(a, a); }

// (X, Y, Z) += (x2, y2): the body of _ec_madd_tile, operation for operation
__device__ __forceinline__ void madd(fp::F& X, fp::F& Y, fp::F& Z,
                                     const fp::F& x2, const fp::F& y2) {
  fp::F Z1Z1 = fp::sqr(Z);
  fp::F U2 = fp::mul(x2, Z1Z1);
  fp::F S2 = fp::mul(y2, fp::mul(Z, Z1Z1));
  fp::F H = fp::sub(U2, X);
  fp::F HH = fp::sqr(H);
  fp::F I = dbl(dbl(HH));
  fp::F J = fp::mul(H, I);
  fp::F r = dbl(fp::sub(S2, Y));
  fp::F V = fp::mul(X, I);
  fp::F X3 = fp::sub(fp::sub(fp::sqr(r), J), dbl(V));
  fp::F Y3 = fp::sub(fp::mul(r, fp::sub(V, X3)), dbl(fp::mul(Y, J)));
  fp::F ZH = fp::add(Z, H);
  Z = fp::sub(fp::sub(fp::sqr(ZH), Z1Z1), HH);
  X = X3;
  Y = Y3;
}

// 2^256 mod p: the Montgomery form of 1
__device__ __forceinline__ fp::F one_mont() {
  fp::F r;
  r.v[0] = 0xffffffe1u;
#pragma unroll
  for (int k = 1; k < 6; k++) r.v[k] = 0xffffffffu;
  r.v[6] = 0xfffffdf0u;
  r.v[7] = 0x07ffffffu;
  return r;
}

template <int BITS>
__global__ void __launch_bounds__(WALK_THREADS, WALK_MIN_BLOCKS)
walk_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
            const uint32_t* __restrict__ table,
            const uint32_t* __restrict__ shift, long long M,
            uint32_t* __restrict__ X_out, uint32_t* __restrict__ Y_out,
            uint32_t* __restrict__ Z_out) {
  constexpr int PER_LIMB = 32 / BITS;   // windows per u32 limb
  constexpr int W = 8 * PER_LIMB;       // windows per input
  constexpr uint32_t MASK = (1u << BITS) - 1;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < M;
       i += stride) {
    fp::F X = fp::load(shift), Y = fp::load(shift + 8), Z = one_mont();
    // q: the limbs not yet consumed, the current one in q.v[0], shifted so
    // that its low BITS bits are the next window's value
    fp::F q = fp::load(a + i * 8);
    fp::F nx = fp::zero(), ny = fp::zero();
    uint32_t vn = q.v[0] & MASK;
    if (vn != 0) {
      const uint32_t* row = table + (long long)vn * 16;
      nx = fp::load(row);
      ny = fp::load(row + 8);
    }
#pragma unroll 1
    for (int w = 0; w < 2 * W; w++) {
      const uint32_t v = vn;
      const fp::F x2 = nx, y2 = ny;
      // advance to window w + 1 and start its row's load
      if ((w + 1) % PER_LIMB != 0) {
        q.v[0] >>= BITS;
      } else if (w + 1 == W) {
        q = fp::load(b + i * 8);
      } else {
#pragma unroll
        for (int k = 0; k < 7; k++) q.v[k] = q.v[k + 1];
      }
      vn = w + 1 < 2 * W ? q.v[0] & MASK : 0;
      if (vn != 0) {
        const uint32_t* row =
            table + (((long long)(w + 1) << BITS) + vn) * 16;
        nx = fp::load(row);
        ny = fp::load(row + 8);
      }
      if (v != 0) madd(X, Y, Z, x2, y2);
    }
    fp::store(X_out + i * 8, X);
    fp::store(Y_out + i * 8, Y);
    fp::store(Z_out + i * 8, Z);
  }
}

}  // namespace

extern "C" int ec_madd_walk(const void* a, const void* b, const void* table,
                            const void* shift, int window_bits, long long M,
                            void* X, void* Y, void* Z, void* stream) {
  if (window_bits != 8 && window_bits != 16) return (int)cudaErrorInvalidValue;
  if (M > 0) {
    long long blocks = (M + WALK_THREADS - 1) / WALK_THREADS;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    const uint32_t *pa = (const uint32_t*)a, *pb = (const uint32_t*)b,
                   *pt = (const uint32_t*)table, *ps = (const uint32_t*)shift;
    if (window_bits == 16)
      walk_kernel<16><<<(unsigned)blocks, WALK_THREADS, 0,
                        (cudaStream_t)stream>>>(
          pa, pb, pt, ps, M, (uint32_t*)X, (uint32_t*)Y, (uint32_t*)Z);
    else
      walk_kernel<8><<<(unsigned)blocks, WALK_THREADS, 0,
                       (cudaStream_t)stream>>>(
          pa, pb, pt, ps, M, (uint32_t*)X, (uint32_t*)Y, (uint32_t*)Z);
  }
  return (int)cudaGetLastError();
}
