// 3xTF32 on Hopper's tensor cores: the split, the m16n8k8 product, the
// cp.async copies and the non-finite rule's FMA recompute shared by
// matmul.cu, q4_matmul.cu, flash_attention.cu and flash_attention_bwd.cu
// (lru_scan.cu takes the copies only).
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
// Non-finite operands.  3xTF32 cannot carry an infinity: for x = +-inf,
// big = +-inf and small = inf - inf = NaN, and for a finite x whose TF32
// rounding overflows (|bits| >= 0x7f7ff000, about 3.4026e38) big = +-inf
// and small = -+inf.  Every product that touches such an x is then NaN
// (a_small.b_big + a_big.b_small is NaN whatever b is, 0 included), where
// the IEEE fp32 product gives +-inf, NaN or a finite value.  No split
// repairs that alone: with small = 0 for an infinite x, x.b for an exact
// b = 1 (b_small = 0) still adds inf.0 = NaN through the cross term.  So
// the split stays two instructions and the kernels apply a rule per output
// tile: after the 3xTF32 sum a block that finds a non-finite value among
// its valid outputs recomputes the tile with the IEEE fp32 FMA loop over
// the same operands (fma_tile below; flash attention has its own exact
// loop) and adds one to a device counter.  A tile that touches an infinite,
// NaN or near-max operand always sums to NaN, so it always takes that path;
// a tile whose operands and product are finite never does (the counter
// reads 0 on them).
//
// The tensor cores add each product into the fp32 accumulator with
// truncation, not rounding to nearest, which biases a long sum toward zero
// (a 4096-deep product summed that way is several times less accurate than
// the FMA loop).  So the kernels sum a few products from zero and add that
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
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// The non-finite rule's recompute of the block's 128 x 128 output tile by
// the IEEE fp32 FMA loop, k in order: C[r][c] = sum over k of
// fmaf(a(r, k), b(k, c), C[r][c]), stored through store(r, c, value).  The
// thread computes the outputs the m64 wgmma accumulator layout gives it,
// rows 8 j + 2 t + (e & 1) and columns n0 (e < 2) or n1 of the tile.
// a(r, k) and b(k, c) return the operands' elements widened to f32, zero
// outside the matrix.  32 k at a time are staged in smem (2 x 32 x 129
// floats); every thread of the block calls it.  Not inlined, so the fast
// path does not carry its registers; the functors are captured by value.
template <typename FA, typename FB, typename FS>
__device__ __noinline__ void fma_tile(float* smem, int K, int t, int n0,
                                      int n1, FA a, FB b, FS store) {
  constexpr int S = 129;  // row stride: the staging stores and the reads
                          // are free of bank conflicts
  float* As = smem;       // As[kk * S + r]
  float* Bs = smem + 32 * S;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    __syncthreads();  // the last step's reads are done
    for (int q = threadIdx.x; q < 32 * 128; q += blockDim.x) {
      As[(q & 31) * S + (q >> 5)] = a(q >> 5, k0 + (q & 31));
      Bs[(q >> 7) * S + (q & 127)] = b(k0 + (q >> 7), q & 127);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < 32; ++kk) {
      const float b0 = Bs[kk * S + n0], b1 = Bs[kk * S + n1];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * j + e] = fmaf(As[kk * S + 8 * j + 2 * t + (e & 1)],
                                e < 2 ? b0 : b1, acc[4 * j + e]);
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store(8 * j + 2 * t + (e & 1), e < 2 ? n0 : n1, acc[4 * j + e]);
}

// four elements (16-byte aligned f32, 8-byte aligned bf16), widened to f32
__device__ __forceinline__ float4 read4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 read4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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


// -- warpgroup products (matmul.cu, q4_matmul.cu) ---------------------------

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= a b^T for one warpgroup: a 64 x 8 from registers (the m16n8k8 A
// layout per warp), b 128 x 8 K-major in shared memory; scale_d = 0 starts
// the sum from zero
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// shared-memory writes made by threads visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// keep the compiler from moving reads of d across the wait
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// four consecutive elements (aligned to their size) into the ring as they
// are, zeros when !ok
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void copy4(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, bool ok) {
  cp_async8(dst, src, ok);
}

// elements row[col .. col + 3] that lie below limit, zeros elsewhere, in
// one 16-byte (f32) / 8-byte (bf16) store
template <typename T>
__device__ __forceinline__ void load4_guarded(T* dst, const T* row, int col,
                                              int limit) {
  struct alignas(4 * sizeof(T)) Four {
    T x[4];
  } v;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v.x[j] = col + j < limit ? row[col + j] : narrow<T>(0.f);
  *reinterpret_cast<Four*>(dst) = v;
}

// split<X3>, except that a widened bf16 value (X3 = false) is exact in TF32,
// so its bits are big as they are
template <bool X3>
__device__ __forceinline__ void split_exact(float x, uint32_t& big,
                                            uint32_t& small) {
  if constexpr (X3)
    split<true>(x, big, small);
  else
    big = __float_as_uint(x);
}

}  // namespace tf32x3
