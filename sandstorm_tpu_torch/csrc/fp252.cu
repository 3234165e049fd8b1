// Kernel 1: elementwise Fp252 multiply, add and subtract.
//
// Replaces sandstorm_tpu/fields/fp252_pallas.py:montmul_digitmajor (body
// _montmul_kernel -> _montmul_tile, _cond_sub_p_tile) and the XLA digit ops
// behind Fp252.add/sub/neg.  from_mont and to_bytes_words are a multiply by
// the canonical 1, neg a subtract from 0: the same three kernels carry them.
//
// Bound on the H100: integer-multiply throughput.  One element is 32 B in
// per operand and 32 B out for ~64 wide multiply-adds and ~100 adds with
// carry, far above the card's bytes-per-operation line.  Design: one thread
// per element, all eight limbs and the 17-limb product in registers, no
// shared memory; the REDC uses p's three nonzero limbs only.
//
// Broadcasting without copies: operand x of an n-element result is read at
// index (i / x_div) % x_mod, which covers a scalar (div 1, mod 1), a short
// period tiled along the result (div 1, mod period) and a table repeated
// over trailing batch dimensions (div = batch, mod = rows).
#include <cuda_runtime.h>

#include "fp252.cuh"

namespace {

template <int OP>
__global__ void binop_kernel(const uint32_t* __restrict__ a, long long a_div,
                             long long a_mod, const uint32_t* __restrict__ b,
                             long long b_div, long long b_mod,
                             uint32_t* __restrict__ out, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long ia = (a_div == 1 ? i : i / a_div) % a_mod;
    long long ib = (b_div == 1 ? i : i / b_div) % b_mod;
    fp::F x = fp::load(a + ia * 8);
    fp::F y = fp::load(b + ib * 8);
    fp::F r = OP == 0 ? fp::add(x, y) : (OP == 1 ? fp::sub(x, y) : fp::mul(x, y));
    fp::store(out + i * 8, r);
  }
}

template <int OP>
int launch(const void* a, long long a_div, long long a_mod, const void* b,
           long long b_div, long long b_mod, void* out, long long n,
           void* stream) {
  if (n > 0) {
    long long blocks = (n + 255) / 256;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    binop_kernel<OP><<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, a_div, a_mod, (const uint32_t*)b, b_div, b_mod,
        (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fp252_add(const void* a, long long a_div, long long a_mod,
                         const void* b, long long b_div, long long b_mod,
                         void* out, long long n, void* stream) {
  return launch<0>(a, a_div, a_mod, b, b_div, b_mod, out, n, stream);
}

extern "C" int fp252_sub(const void* a, long long a_div, long long a_mod,
                         const void* b, long long b_div, long long b_mod,
                         void* out, long long n, void* stream) {
  return launch<1>(a, a_div, a_mod, b, b_div, b_mod, out, n, stream);
}

extern "C" int fp252_mul(const void* a, long long a_div, long long a_mod,
                         const void* b, long long b_div, long long b_mod,
                         void* out, long long n, void* stream) {
  return launch<2>(a, a_div, a_mod, b, b_div, b_mod, out, n, stream);
}
