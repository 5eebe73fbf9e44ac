// Dequant-fused int4 matmul for Hopper (sm_90a):
//   C[z] = A[z] @ dequantize_q4(P[z], S[z]).
//
// Replaces the TPU kernel src/repro/kernels/quant.py::q4_matmul_pallas, the
// product behind ag_matmul(..., precision="lossy", use_kernel=True).  The
// weight arrives as the q4_shared wire format: P is uint8 (K/2, N), byte r
// holding K rows 2r (low nibble) and 2r+1 (high nibble) as code + 8; S is
// f32 (K/group, N), one scale per length-`group` run of K rows per column.
// The weight is never densified in device memory: each k tile's PACKED bytes
// are staged in shared memory and unpacked there (code - 8, times the scale
// of row k / group) into the f32 tile the FMA loop reads.
//
// On the TPU a sequential k grid axis, pinned to one scale group per step,
// carried a (block_m, block_n) fp32 accumulator in VMEM scratch.  Here blocks
// run in parallel with no order, so each block owns one 128x128 output tile
// for its whole life and walks K in a loop with the accumulator in registers
// (8x8 per thread, fp32), written once — the structure of csrc/matmul.cu.
// The scale is looked up per k row, so any even group dividing K works
// (group = 32 included; the TPU's group >= 64 tile floor does not apply).
//
// What bounds it: at the main path's shape (8 ranks x 2048 x 7168 x 5120)
// the work is 2*M*N*K FLOP against A read once, the packed weight (half a
// byte per element), the scales and C written once — ~1200 FLOP per byte, so
// the card's fp32 FMA rate is the bound.  Arithmetic is IEEE fp32 FMA
// (fmaf), never TF32; bf16 A is widened to fp32 in shared memory and the
// output is rounded to A's dtype.  The dequantized tile equals
// dequantize_q4 element for element (one exact product code * scale), and
// the FMA order is csrc/matmul.cu's.
//
// What the simple design gives up: no tensor cores (wgmma / mma.sync), no
// TMA or cp.async pipelining (the next tile is prefetched through registers
// only), scalar and byte global loads instead of vector loads, one shared-
// memory stage, and a third barrier per k tile for the unpack step.  Ragged
// M and N are masked in the loads (zero fill) and the store; K is a multiple
// of `group` by contract.
//
// blockIdx.z walks an optional leading batch (the rank axis), so one launch
// covers every rank's chunk product.  Plain C entry points (no PyTorch
// headers) keep the build to one nvcc call; each returns cudaGetLastError()
// after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;  // even: a k tile is BK / 2 packed rows
constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    q4_panel_matmul(const T* __restrict__ A, const uint8_t* __restrict__ P,
                    const float* __restrict__ S, T* __restrict__ C, int M,
                    int N, int K, int group, long long sa, long long sp,
                    long long ss, long long sc) {
  __shared__ __align__(16) float As[BK][BM];         // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];         // dequantized weight tile
  __shared__ __align__(16) uint8_t Ps[BK / 2][BN];   // packed weight tile

  const int tid = threadIdx.x;
  A += blockIdx.z * sa;
  P += blockIdx.z * sp;
  S += blockIdx.z * ss;
  C += blockIdx.z * sc;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int K2 = K / 2;

  // Loads: 4 elements of the A tile (one row, 4 k) and 2 consecutive packed
  // bytes of the weight tile per thread.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int p_row = tid >> 6;
  const int p_col = (tid & 63) * 2;
  // Unpack: thread owns 4 consecutive columns of one k row of Bs.
  const int u_k = tid >> 5;
  const int u_col = (tid & 31) * 4;
  // Compute: as csrc/matmul.cu — rows ty*4+{0..3}, 64+ty*4+{0..3}, and the
  // same split of columns.
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[4];
  uint8_t rp[2];
  const int ar = row0 + a_row;

#define LOAD_TILES(k0)                                                   \
  _Pragma("unroll") for (int i = 0; i < 4; ++i) {                        \
    const int ka = (k0) + a_k + i;                                       \
    ra[i] = (ar < M && ka < K) ? widen(A[(long long)ar * K + ka]) : 0.f; \
  }                                                                      \
  _Pragma("unroll") for (int i = 0; i < 2; ++i) {                        \
    const int kp = (k0) / 2 + p_row;                                     \
    const int c = col0 + p_col + i;                                      \
    rp[i] = (kp < K2 && c < N) ? P[(long long)kp * N + c] : 0;           \
  }

  LOAD_TILES(0)
  for (int k0 = 0; k0 < K; k0 += BK) {
    // this tile's scales for the unpack step: row k0 + u_k, group (k / group)
    float rs[4];
    const int ks = k0 + u_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = col0 + u_col + i;
      rs[i] = (ks < K && c < N) ? S[(long long)(ks / group) * N + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_k + i][a_row] = ra[i];
    *reinterpret_cast<uchar2*>(&Ps[p_row][p_col]) = make_uchar2(rp[0], rp[1]);
    __syncthreads();  // packed tile visible
    {
      // low nibble = even k row, high nibble = odd k row; code - 8, times
      // the row's group scale (zero outside the matrix)
      const uchar4 b = *reinterpret_cast<const uchar4*>(&Ps[u_k >> 1][u_col]);
      const int sh = (u_k & 1) * 4;
      const float w0 = (float)((int)((b.x >> sh) & 0xF) - 8) * rs[0];
      const float w1 = (float)((int)((b.y >> sh) & 0xF) - 8) * rs[1];
      const float w2 = (float)((int)((b.z >> sh) & 0xF) - 8) * rs[2];
      const float w3 = (float)((int)((b.w >> sh) & 0xF) - 8) * rs[3];
      *reinterpret_cast<float4*>(&Bs[u_k][u_col]) = make_float4(w0, w1, w2, w3);
    }
    __syncthreads();  // dequantized tile visible
    if (k0 + BK < K) {
      LOAD_TILES(k0 + BK)  // next tile's loads overlap this tile's FMAs
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // before the next tile overwrites As, Ps and Bs
  }
#undef LOAD_TILES

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < N) C[(long long)r * N + c] = narrow<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* p, const void* s, void* c, int batch,
           int M, int N, int K, int group, long long sa, long long sp,
           long long ss, long long sc, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  q4_panel_matmul<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const uint8_t*>(p),
      static_cast<const float*>(s), static_cast<T*>(c), M, N, K, group, sa,
      sp, ss, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_q4_matmul_f32(const void* a, const void* p,
                                   const void* s, void* c, int batch, int M,
                                   int N, int K, int group, long long sa,
                                   long long sp, long long ss, long long sc,
                                   void* stream) {
  return launch<float>(a, p, s, c, batch, M, N, K, group, sa, sp, ss, sc,
                       stream);
}

extern "C" int repro_q4_matmul_bf16(const void* a, const void* p,
                                    const void* s, void* c, int batch, int M,
                                    int N, int K, int group, long long sa,
                                    long long sp, long long ss, long long sc,
                                    void* stream) {
  return launch<__nv_bfloat16>(a, p, s, c, batch, M, N, K, group, sa, sp, ss,
                               sc, stream);
}
