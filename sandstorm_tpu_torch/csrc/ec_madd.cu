// Kernel 5: the Pedersen subset-sum walk, one mixed EC add per window.
//
// Replaces sandstorm_tpu/fields/fp252_pallas.py:ec_madd_digitmajor (body
// _ec_madd_kernel -> _ec_madd_tile): one mixed Jacobian + affine add
// (madd-2007-bl, 7M + 4S), kept where the window value is 0.  The TPU ran one
// madd per pallas_call over digit-major [16, n] blocks and walked the 32
// windows with lax.scan, gathering each window's table rows into HBM in
// between (hashing/pedersen_tpu.py:_hash_pairs_core16).  Here one thread
// carries one hash through the whole walk: it reads its window values
// straight from the canonical input limbs, gathers the affine row (x2, y2) of
// each nonzero window from the table, and keeps X, Y, Z in registers from
// the shift point (Z = 1) to the end, so nothing but the table rows and the
// final X, Y, Z touch device memory.
//
// Bound on the H100: integer multiply throughput (11 montmuls of ~64 wide
// multiply-adds each per window, 32 or 64 windows per hash) and, behind it,
// the random 64-byte row gathers from a table larger than the 50 MB L2 (the
// 16-bit table is 128 MB).  This first version is the simple one: a thread
// per hash, one launch per tree level, no staging of rows; later work can
// group hashes per warp and stage rows with cp.async.
//
// Table: [2 W][2^bits][16] u32, row = x limbs then y limbs of an affine
// point in Montgomery form; windows 0..W-1 belong to input a, W..2W-1 to
// input b, W = 256 / bits.  Entry 0 of each window is never read.
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

__device__ __forceinline__ fp::F dbl(const fp::F& a) { return fp::add(a, a); }

// (X, Y, Z) += (x2, y2): the body of _ec_madd_tile, operation for operation
__device__ __forceinline__ void madd(fp::F& X, fp::F& Y, fp::F& Z,
                                     const fp::F& x2, const fp::F& y2) {
  fp::F Z1Z1 = fp::mul(Z, Z);
  fp::F U2 = fp::mul(x2, Z1Z1);
  fp::F S2 = fp::mul(y2, fp::mul(Z, Z1Z1));
  fp::F H = fp::sub(U2, X);
  fp::F HH = fp::mul(H, H);
  fp::F I = dbl(dbl(HH));
  fp::F J = fp::mul(H, I);
  fp::F r = dbl(fp::sub(S2, Y));
  fp::F V = fp::mul(X, I);
  fp::F X3 = fp::sub(fp::sub(fp::mul(r, r), J), dbl(V));
  fp::F Y3 = fp::sub(fp::mul(r, fp::sub(V, X3)), dbl(fp::mul(Y, J)));
  fp::F ZH = fp::add(Z, H);
  Z = fp::sub(fp::sub(fp::mul(ZH, ZH), Z1Z1), HH);
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
__global__ void walk_kernel(const uint32_t* __restrict__ a,
                            const uint32_t* __restrict__ b,
                            const uint32_t* __restrict__ table,
                            const uint32_t* __restrict__ shift, long long M,
                            uint32_t* __restrict__ X_out,
                            uint32_t* __restrict__ Y_out,
                            uint32_t* __restrict__ Z_out) {
  constexpr int PER_LIMB = 32 / BITS;   // windows per u32 limb
  constexpr int W = 8 * PER_LIMB;       // windows per input
  constexpr uint32_t MASK = (1u << BITS) - 1;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < M;
       i += stride) {
    fp::F X = fp::load(shift), Y = fp::load(shift + 8), Z = one_mont();
#pragma unroll 1
    for (int w = 0; w < 2 * W; w++) {
      const uint32_t* s = (w < W ? a : b) + i * 8;
      int k = w < W ? w : w - W;
      uint32_t v = (s[k / PER_LIMB] >> (BITS * (k % PER_LIMB))) & MASK;
      if (v != 0) {
        const uint32_t* row = table + (((long long)w << BITS) + v) * 16;
        fp::F x2 = fp::load(row), y2 = fp::load(row + 8);
        madd(X, Y, Z, x2, y2);
      }
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
    long long blocks = (M + 127) / 128;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    const uint32_t *pa = (const uint32_t*)a, *pb = (const uint32_t*)b,
                   *pt = (const uint32_t*)table, *ps = (const uint32_t*)shift;
    if (window_bits == 16)
      walk_kernel<16><<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
          pa, pb, pt, ps, M, (uint32_t*)X, (uint32_t*)Y, (uint32_t*)Z);
    else
      walk_kernel<8><<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
          pa, pb, pt, ps, M, (uint32_t*)X, (uint32_t*)Y, (uint32_t*)Z);
  }
  return (int)cudaGetLastError();
}
