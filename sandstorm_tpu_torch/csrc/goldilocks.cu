// Goldilocks elementwise kernels: multiply, add, subtract, and the GF(p^3)
// multiply.
//
// Replaces the XLA routines GL.add/sub/mul and GL3.mul of
// sandstorm_tpu/fields/goldilocks.py and gl3.py (GL3.mul :284 is 9 GL
// muls, 6 adds and 2 muls by x^3 = 2 composed: 17 ops, each its own pass
// over the arrays), which in the JAX package compute what the Goldilocks
// NTT leaf's tile ops (fields/gl_pallas.py:29/40/47) compute.
//
// Bound on the H100: device memory.  A GL op reads 16 B and writes 8 B for
// a handful of 64-bit operations; a gl3_mul reads 48 B and writes 24 B for
// 9 wide multiplies.  Design: one thread per element, loads of whole
// elements (u64 words), and gl3_mul keeps the 9 products, the additions and
// the x^3 = 2 reduction in registers: one launch where the JAX form has 17.
//
// Broadcasting without copies, as in fp252.cu: operand x of an n-element
// result is read at index (i / x_div) % x_mod (a scalar, a tiled period, a
// table repeated over trailing batch dimensions).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

template <int OP>
__global__ void gl_binop_kernel(const uint32_t* __restrict__ a,
                                long long a_div, long long a_mod,
                                const uint32_t* __restrict__ b,
                                long long b_div, long long b_mod,
                                uint32_t* __restrict__ out, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long ia = (a_div == 1 ? i : i / a_div) % a_mod;
    long long ib = (b_div == 1 ? i : i / b_div) % b_mod;
    uint64_t x = gl::load(a + ia * 2), y = gl::load(b + ib * 2);
    uint64_t r = OP == 0 ? gl::add(x, y)
                         : (OP == 1 ? gl::sub(x, y) : gl::mul(x, y));
    gl::store(out + i * 2, r);
  }
}

// GF(p^3) = GF(p)[x] / (x^3 - 2) (goldilocks.cuh gl3::mul); an element
// is (c0, c1, c2), 6 u32 words
__global__ void gl3_mul_kernel(const uint32_t* __restrict__ a,
                               long long a_div, long long a_mod,
                               const uint32_t* __restrict__ b,
                               long long b_div, long long b_mod,
                               uint32_t* __restrict__ out, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t* pa = a + ((a_div == 1 ? i : i / a_div) % a_mod) * 6;
    const uint32_t* pb = b + ((b_div == 1 ? i : i / b_div) % b_mod) * 6;
    gl3::store(out + i * 6, gl3::mul(gl3::load(pa), gl3::load(pb)));
  }
}

template <typename Kernel>
int launch(Kernel kernel, const void* a, long long a_div, long long a_mod,
           const void* b, long long b_div, long long b_mod, void* out,
           long long n, void* stream) {
  if (n > 0) {
    long long blocks = (n + 255) / 256;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;
    kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, a_div, a_mod, (const uint32_t*)b, b_div, b_mod,
        (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gl_add(const void* a, long long a_div, long long a_mod,
                      const void* b, long long b_div, long long b_mod,
                      void* out, long long n, void* stream) {
  return launch(gl_binop_kernel<0>, a, a_div, a_mod, b, b_div, b_mod, out, n,
                stream);
}

extern "C" int gl_sub(const void* a, long long a_div, long long a_mod,
                      const void* b, long long b_div, long long b_mod,
                      void* out, long long n, void* stream) {
  return launch(gl_binop_kernel<1>, a, a_div, a_mod, b, b_div, b_mod, out, n,
                stream);
}

extern "C" int gl_mul(const void* a, long long a_div, long long a_mod,
                      const void* b, long long b_div, long long b_mod,
                      void* out, long long n, void* stream) {
  return launch(gl_binop_kernel<2>, a, a_div, a_mod, b, b_div, b_mod, out, n,
                stream);
}

extern "C" int gl3_mul(const void* a, long long a_div, long long a_mod,
                       const void* b, long long b_div, long long b_mod,
                       void* out, long long n, void* stream) {
  return launch(gl3_mul_kernel, a, a_div, a_mod, b, b_div, b_mod, out, n,
                stream);
}
