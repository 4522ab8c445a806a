// Device helpers shared by the attention kernels (flash_attn.cu,
// flash_attn_bwd.cu, banded_attn_bwd.cu) and the RNN-T sweeps (rnnt.cu):
// asynchronous copies into shared memory, and fp32-accurate products on
// the tensor cores as 3xTF32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// element strides of q, k or v over batch, head and time; d is contiguous
struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous copies into shared memory; with ok false the bytes are zeroed
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// until at most N of this thread's groups of copies are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo + O(2^-22 x), both parts TF32 rounded to nearest, ties away
// from zero, as cvt.rna.tf32.f32 rounds a finite x: half a TF32 ulp added
// to the magnitude's bits, then the 13 low bits dropped. The mma reads only
// the top 19 bits of a register, so lo is left unmasked. cvt.rna would add
// checks for infinities, which no operand here can be.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the small cross terms first, then hi * hi, formed
// from zero and added to c in fp32 rounded to nearest on the CUDA cores.
// The tensor cores' accumulator truncates each sum (rounds toward zero),
// so a long chain of k steps accumulated there drifts by a bias of ~2^-23
// a step: over 501 keys (63 steps of 3) K1's output landed 2.6e-5 from
// its plain version, and the backward's D = rowsum(do * o) moved a
// gradient that is zero in exact arithmetic (a key bias under the
// softmax) past a card-against-CPU check; with each step's three products
// from zero only they share the truncation.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], t[e]);
}

// rows [0, nrows) of a (rows x d) matrix whose row i starts at
// src + i * stride into shared memory rows of SK floats; rows at or past
// nvalid are zero-filled. 16-byte copies where d, the stride and the base
// allow them, else 4-byte ones; columns d..SK-1 are not written.
template <int SK>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int nrows,
                                          int nvalid, int d, int tid,
                                          int nthr) {
  if (d % 4 == 0 && stride % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int c4 = d >> 2;
    for (int i = tid; i < nrows * c4; i += nthr) {
      const int r = i / c4, c = (i - r * c4) * 4;
      const bool ok = r < nvalid;
      cp_async16(dst + r * SK + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int i = tid; i < nrows * d; i += nthr) {
      const int r = i / d, c = i - r * d;
      const bool ok = r < nvalid;
      cp_async4(dst + r * SK + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

}  // namespace
