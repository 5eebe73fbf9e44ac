// Blocked panel matmul for Hopper (sm_90a): C[z] = A[z] @ B[z].
//
// Replaces the TPU kernel src/repro/kernels/matmul.py::matmul_pallas, the
// SUMMA panel product of the paper's §5.2.1.  On the TPU a sequential k grid
// axis carried a (block_m, block_n) fp32 accumulator in VMEM scratch and wrote
// it out on the last k step.  Here blocks run in parallel with no order, so
// each block owns one 128x128 output tile for its whole life: it walks K in a
// loop, staging 128x8 tiles of A and 8x128 tiles of B in shared memory, and
// keeps its accumulator in registers (8x8 per thread, fp32), written once.
//
// What bounds it: at the SUMMA panel shape (4096^3 per rank, fp32) the work
// is 2*4096^3 FLOP against 3*64 MiB of traffic, ~700 FLOP per byte, so the
// card's fp32 FMA rate is the bound (compute-bound).  f32 inputs run as IEEE
// fp32 FMA on the CUDA cores — never TF32, whose 10-bit mantissa would break
// the reference tolerance.  bf16 inputs are widened to fp32 in shared memory
// and use the same FMA loop; the output is rounded to the input dtype.
//
// What the simple design gives up: no tensor cores (wgmma / mma.sync), no TMA
// or cp.async pipelining (the next tile is prefetched through registers
// only), scalar global loads, one shared-memory stage, no split-K and no
// persistent scheduling.  The ragged M/N/K edges are masked in the loads
// (zero fill) and in the store, so any shape is accepted.
//
// Operands are row-major and contiguous per batch entry; blockIdx.z walks an
// optional leading batch, so one launch covers every rank's panel product of
// a SUMMA round.  Plain C entry points (no PyTorch headers) keep the build to
// one nvcc call; each returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
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
    panel_matmul(const T* __restrict__ A, const T* __restrict__ B,
                 T* __restrict__ C, int M, int N, int K, long long sa,
                 long long sb, long long sc) {
  __shared__ __align__(16) float As[BK][BM];  // A tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  A += blockIdx.z * sa;
  B += blockIdx.z * sb;
  C += blockIdx.z * sc;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // Loads: each thread brings 4 elements of the A tile (one row, 4 k) and
  // 4 of the B tile (one k, 4 consecutive columns).
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int b_k = tid >> 5;
  const int b_col = (tid & 31) * 4;

  // Compute: thread (ty, tx) owns rows ty*4+{0..3}, 64+ty*4+{0..3} and the
  // same split of columns, so a quarter warp's float4 reads of a shared row
  // are one contiguous 128-byte span.
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float ra[4], rb[4];
  const int ar = row0 + a_row;
  const int bc = col0 + b_col;

#define LOAD_TILES(k0)                                                   \
  _Pragma("unroll") for (int i = 0; i < 4; ++i) {                        \
    const int ka = (k0) + a_k + i;                                       \
    ra[i] = (ar < M && ka < K) ? widen(A[(long long)ar * K + ka]) : 0.f; \
    const int kb = (k0) + b_k;                                           \
    rb[i] = (kb < K && bc + i < N) ? widen(B[(long long)kb * N + bc + i])\
                                   : 0.f;                                \
  }

  LOAD_TILES(0)
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_k + i][a_row] = ra[i];
    *reinterpret_cast<float4*>(&Bs[b_k][b_col]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
    __syncthreads();
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
    __syncthreads();
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
int launch(const void* a, const void* b, void* c, int batch, int M, int N,
           int K, long long sa, long long sb, long long sc, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  panel_matmul<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K, sa, sb, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_matmul_f32(const void* a, const void* b, void* c,
                                int batch, int M, int N, int K, long long sa,
                                long long sb, long long sc, void* stream) {
  return launch<float>(a, b, c, batch, M, N, K, sa, sb, sc, stream);
}

extern "C" int repro_matmul_bf16(const void* a, const void* b, void* c,
                                 int batch, int M, int N, int K, long long sa,
                                 long long sb, long long sc, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, batch, M, N, K, sa, sb, sc, stream);
}
