// 3xTF32 on Hopper's tensor cores: the split, the m16n8k8 product and the
// cp.async copies shared by matmul.cu and flash_attention.cu.
//
// An f32 value x is carried as big + small: big = tf32(x), rounded to
// nearest with ties away (the bits of cvt.rna.tf32.f32 for every finite x
// and +-inf, in two integer instructions where cvt.rna takes four), and
// small = x - big, exact in f32 and passed to the tensor core as it is,
// which reads its top 10 mantissa bits (so small is truncated to TF32:
// x - big - tf32(small) is below 2^-21 |x|).  An f32 product a.b then
// runs as three TF32 tensor-core products, a_small.b_big + a_big.b_small +
// a_big.b_big, with fp32 accumulators (a_small.b_small, below 2^-22 of the
// product, is dropped): about as accurate as the IEEE fp32 FMA loop, at
// 3/495 TFLOP/s per FLOP instead of 1/67.  A NaN in x reaches the result
// through small (x - big is NaN whatever big is).  A bf16 value is exact
// in TF32, so a bf16 operand takes the one big.big product (X3 = false):
// the matmul passes a widened bf16 value's bits through as big, flash
// attention takes big from cvt.rna (its P is an f32 softmax value).
//
// The tensor cores add each product into the fp32 accumulator with
// truncation, not rounding to nearest, which biases a long sum toward zero
// (a 4096-deep product summed that way is several times less accurate than
// the FMA loop).  So both kernels sum a few products from zero and add that
// partial sum into their own accumulator with an IEEE add.
//
// mma.m16n8k8 .tf32 fragments (flash_attention.cu), lane = 4 g + t:
//   A (16 x 8, row): a0 = A[g][k0], a1 = A[g+8][k0], a2 = A[g][k1],
//                    a3 = A[g+8][k1];
//   B (8 x 8, col):  b0 = B[k0][g], b1 = B[k1][g];
//   C (16 x 8):      c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//                    c3 = C[g+8][2t+1];
// where PTX names k0 = t and k1 = t + 4.  The sum over k does not care
// which 8 columns of A and rows of B sit in which k slot, only that A and B
// agree, so flash attention puts k0 = 2t and k1 = 2t + 1: a thread's two A
// values of a row are then adjacent (one 8-byte shared load), and the
// score accumulator (c0, c1 = keys 2t, 2t + 1) is already P's A fragment
// for the P.V product.  (The matmul's wgmma reads its shared operand in
// the natural k order, so its register fragments keep k0 = t, k1 = t + 4.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// X3: big = tf32(x) (round to nearest, ties away), small = x - big;
// otherwise big = cvt.rna(x) alone
template <bool X3>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  if constexpr (X3) {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
  } else {
    big = to_tf32(x);
  }
}

// d += a b on one m16n8k8 tile (fp32 accumulators)
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b as 3xTF32 (X3) or as the one big.big product; the small terms
// go first, so the largest term is added last
template <bool X3>
__device__ __forceinline__ void mma3(float* d, const uint32_t* a_big,
                                     const uint32_t* a_small,
                                     const uint32_t* b_big,
                                     const uint32_t* b_small) {
  if constexpr (X3) {
    mma(d, a_small, b_big);
    mma(d, a_big, b_small);
  }
  mma(d, a_big, b_big);
}

// 16-byte global -> shared copy; when !ok nothing is read and the 16 bytes
// are zero-filled (src must still be a valid address)
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 8-byte global -> shared copy (through L1: .cg takes only 16 bytes), with
// the same zero fill
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// four consecutive elements (16-byte aligned f32, 8-byte aligned bf16) into
// a 16-byte aligned shared f32 slot: f32 through cp.async, bf16 widened
// through registers; zeros when !ok
__device__ __forceinline__ void load4(float* dst, const float* src, bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void load4(float* dst, const __nv_bfloat16* src,
                                      bool ok) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    x = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  *reinterpret_cast<float4*>(dst) = x;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// two adjacent outputs, rounded once to T (8-byte / 4-byte aligned)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

}  // namespace tf32x3
