// Dequant-fused int4 matmul on Hopper's tensor cores (sm_90a):
//   C[z] = A[z] @ dequantize_q4(P[z], S[z]).
//
// Replaces the TPU kernel src/repro/kernels/quant.py::q4_matmul_pallas, the
// product behind ag_matmul(..., precision="lossy", use_kernel=True).  The
// weight arrives as the q4_shared wire format: P is uint8 (K/2, N), byte r
// holding K rows 2r (low nibble) and 2r+1 (high nibble) as code + 8; S is
// f32 (K/group, N), one scale per length-`group` run of K rows per column.
// The weight is never densified in device memory: each k tile's PACKED
// bytes and its scale rows are staged in shared memory, and each warp
// unpacks its own fragments from there in registers.
//
// On the TPU a sequential k grid axis, pinned to one scale group per step,
// carried a (block_m, block_n) fp32 accumulator in VMEM scratch.  Here blocks
// run in parallel with no order, so each block owns one 128x128 output tile
// for its whole life, walks K in 32-deep tiles and keeps its fp32
// accumulators in registers, written once.
//
// What bounds it: at the main path's shape (8 ranks x 2048 x 7168 x 5120)
// the work is 2 M N K FLOP against A read once, the packed weight (half a
// byte per element), the scales and C written once, ~1200 FLOP per byte,
// so arithmetic bounds it.  f32 runs as 3xTF32 (tf32x3.cuh), as accurate as
// the fp32 FMA loop: its least time is 3 x FLOP at the card's 495 TFLOP/s
// TF32 rate (7.3 ms at that shape), against FLOP at 67 TFLOP/s for the
// fp32 FMA loop (17.9 ms).
//
// Design: csrc/matmul.cu's, C^T = W^T A^T with warpgroup products
// (wgmma.mma_async m64n128k8 .tf32).  A (K-major) is the shared operand:
// raw A tiles come through a 4-stage cp.async ring and are split once per
// block into 128-byte-swizzled big / small tiles.  W^T is the register
// operand: a ring stage holds the tile's packed bytes (16 x 128) and the
// scale rows it spans (one at group 32) in place of matmul.cu's raw B
// tile, and each warp builds its fragments as (code - 8) * scale, one f32
// multiply (the value dequantize_q4 gives, element for element), then
// splits them into big + small.  f32 A takes three products per fragment
// (w_small.a_big + w_big.a_small + w_big.a_big); bf16 A is exact in TF32
// (a_small = 0) and takes two.  A warp's m16 fragment rows g and g + 8
// take the ADJACENT weight columns 2 g and 2 g + 1 of its 16 (a
// permutation of the tile's columns, undone where C is stored), so one
// 16-bit shared load brings a k row's two codes and one 8-byte load its
// two scales.  The code - 8 is one integer OR and one add (the float bits
// of 2^23 + code, minus 2^23 + 8).  As in matmul.cu, a tile's products sum
// from zero and are added into the fp32 accumulator with IEEE adds once
// per tile (the tensor cores truncate as they accumulate), and a quarter
// of the copies of the tile 3 ahead and of the next tile's split is issued
// after each k-step.  One barrier per tile; 177 KB of dynamic shared
// memory, one block per SM.
//
// Every operand shape the wrapper takes works: any even group dividing K
// (a tile may span up to 16 scale rows at group 2, or share one with the
// next at group 64; the general case divides per k row), ragged M, N and K
// (zero-filled loads, guarded stores), and rows that are not 16-byte
// aligned (N = 129: guarded element-wise loads into the same ring).
// Non-finite and near-max operands follow tf32x3.cuh's rule: a block whose
// tile holds a non-finite output recomputes it with the fp32 FMA loop,
// dequantizing as it loads, and counts that in *recomputes.
//
// What it still gives up: TMA with a producer warp, a persistent tile
// schedule, two blocks per SM (254 registers a thread allow one), and a
// bf16 wgmma for bf16 A.  The ring depth was chosen on the card among 3,
// 4 and 5 stages at the main shape.
//
// blockIdx.z walks an optional leading batch (the rank axis), so one launch
// covers every rank's chunk product.  Plain C entry points (no PyTorch
// headers) keep the build to one nvcc call; each returns the launch's CUDA
// error code.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int BM = 128;      // C rows per block (the wgmma's N)
constexpr int BN = 128;      // C columns: 2 warpgroups x 64 (the wgmma's M)
constexpr int BK = 32;       // one 128-byte swizzle row of f32
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int RAW_A = BM * BK;                // raw A tile (floats; bf16
                                              // fills half)
constexpr int SP = BN + 16;                   // packed row stride (bytes):
                                              // fragment reads conflict-free
constexpr int PACKED_BYTES = BK / 2 * SP;     // the tile's 16 packed rows
constexpr int SROWS = 17;                     // scale rows a tile can span
constexpr int SS = BN + 4;                    // scale row stride (floats)
constexpr int STAGE_BYTES =
    sizeof(float) * RAW_A + PACKED_BYTES + sizeof(float) * SROWS * SS;
constexpr int SPLIT_FLOATS = BM * BK;         // one swizzled 16 KB tile
// [big 0][small 0][big 1][small 1] (1024-byte aligned) then the ring
constexpr int SMEM_BYTES =
    sizeof(float) * 4 * SPLIT_FLOATS + STAGES * STAGE_BYTES + 1024;
static_assert(STAGE_BYTES % 16 == 0, "ring stages stay 16-byte aligned");

// code - 8 as f32 for the low nibble of v: the bits of 2^23 + code, minus
// 2^23 + 8 (exact)
__device__ __forceinline__ float code(uint32_t v) {
  return __uint_as_float(0x4B000000u | (v & 0xFu)) - 8388616.f;
}

// ONE_ROW: group is a multiple of BK, so a tile's k rows share one scale
// row (no division per k row)
template <typename T, bool ONE_ROW>
__global__ void __launch_bounds__(THREADS, 1)
    q4_panel_matmul(const T* __restrict__ A, const uint8_t* __restrict__ P,
                    const float* __restrict__ S, T* __restrict__ C, int M,
                    int N, int K, int group, long long sa, long long sp,
                    long long ss, long long sc, int vec_a, int vec_p,
                    int vec_s, int* __restrict__ recomputes) {
  constexpr bool X3 = std::is_same<T, float>::value;  // A split in two
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* split_buf = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(split_buf + 4 * SPLIT_FLOATS);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nw = 64 * (warp >> 2) + 16 * (warp & 3);  // the warp's columns
  const int nc = nw + 2 * g;  // this thread's two: nc (row g), nc + 1
  A += blockIdx.z * sa;
  P += blockIdx.z * sp;
  S += blockIdx.z * ss;
  C += blockIdx.z * sc;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;
  const int K2 = K / 2, KG = K / group;

  // quarter i of tile kt into ring slot s: chunk tid + 256 i of A (128 rows
  // x 8 chunks of 4), rows read coalesced; quarter 0 also the 16 packed
  // rows (8 chunks of 16 bytes each), quarter 1 the scale rows the tile
  // spans (32 chunks of 4 each; rows past K / group zero-filled)
  auto load_part = [&](int kt, int s, int i) {
    unsigned char* stage = ring + s * STAGE_BYTES;
    const int k0 = kt * BK;
    const int q = tid + i * THREADS;
    {
      T* As = reinterpret_cast<T*>(stage);
      const int r = q >> 3, kc = k0 + (q & 7) * 4;
      const int gr = row0 + r;
      T* dst = As + r * BK + (q & 7) * 4;
      if (vec_a) {
        const bool ok = gr < M && kc < K;
        copy4(dst, ok ? A + (long long)gr * K + kc : A, ok);
      } else {
        load4_guarded(dst, A + (long long)gr * K, kc, gr < M ? K : 0);
      }
    }
    if (i == 0 && tid < 128) {
      const int r = tid >> 3, c = (tid & 7) * 16;
      const int gk = k0 / 2 + r, gn = col0 + c;
      uint8_t* dst = stage + sizeof(float) * RAW_A + r * SP + c;
      if (vec_p) {
        const bool ok = gk < K2 && gn < N;
        cp_async16(dst, ok ? P + (long long)gk * N + gn : P, ok);
      } else {
        alignas(16) uint8_t v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j)
          v[j] = gk < K2 && gn + j < N ? P[(long long)gk * N + gn + j] : 0;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
    if (i == 1) {
      float* Ss = reinterpret_cast<float*>(stage + sizeof(float) * RAW_A +
                                           PACKED_BYTES);
      const int r_lo = k0 / group;
      const int rows = ONE_ROW ? 1 : (k0 + BK - 1) / group - r_lo + 1;
      for (int x = tid; x < rows * 32; x += THREADS) {
        const int r = x >> 5, c = (x & 31) * 4;
        const int gr = r_lo + r;
        float* dst = Ss + r * SS + c;
        if (vec_s) {
          const bool ok = gr < KG && col0 + c < N;
          cp_async16(dst, ok ? S + (long long)gr * N + col0 + c : S, ok);
        } else {
          load4_guarded(dst, S + (long long)gr * N + col0, c,
                        gr < KG ? N - col0 : 0);
        }
      }
    }
  };

  // quarter i of the raw A tile in slot s -> big / small tiles of split
  // buffer `buf`, 16-byte chunk c of row r at chunk c ^ (r % 8) (the
  // 128-byte swizzle)
  auto split_part = [&](int s, int buf, int i) {
    const T* raw = reinterpret_cast<const T*>(ring + s * STAGE_BYTES);
    float* big = split_buf + buf * 2 * SPLIT_FLOATS;
    const int q = tid + i * THREADS;
    const int r = q >> 3, c = q & 7;
    const float4 x = read4(raw + r * BK + c * 4);
    uint4 hb, hs;
    split_exact<X3>(x.x, hb.x, hs.x);
    split_exact<X3>(x.y, hb.y, hs.y);
    split_exact<X3>(x.z, hb.z, hs.z);
    split_exact<X3>(x.w, hb.w, hs.w);
    const int off = r * BK + ((c ^ (r & 7)) << 2);
    *reinterpret_cast<uint4*>(big + off) = hb;
    if constexpr (X3)
      *reinterpret_cast<uint4*>(big + SPLIT_FLOATS + off) = hs;
  };

  float acc[64], d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k)
#pragma unroll
      for (int i = 0; i < 4; ++i) load_part(s, s, i);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();  // tile 0 has landed (this thread's part)
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) split_part(0, 0, i);
  fence_proxy_async();
  cp_async_wait<STAGES - 3>();  // tile 1 too
  __syncthreads();

  for (int kt = 0; kt < n_k; ++kt) {
    // W^T fragments of the tile's 4 k-steps (the m16n8k8 A layout: rows g,
    // g + 8 = columns nc, nc + 1; k slots t, t + 4 of step s = k rows
    // 8 s + t (+4), packed row 4 s + t / 2 (+2), nibble t & 1)
    const unsigned char* stage = ring + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* Ps = stage + sizeof(float) * RAW_A + nc;
    const float* Ss = reinterpret_cast<const float*>(
                          stage + sizeof(float) * RAW_A + PACKED_BYTES) + nc;
    const int k0 = kt * BK, r_lo = ONE_ROW ? 0 : k0 / group;
    const float2 s_one = *reinterpret_cast<const float2*>(Ss);
    const int sh = 4 * (t & 1);
    uint32_t fb[4][4], fs[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = 8 * s + t + 4 * h;
        const uint32_t v =
            *reinterpret_cast<const uint16_t*>(Ps + (kk >> 1) * SP) >> sh;
        float2 sc = s_one;
        if constexpr (!ONE_ROW)
          sc = *reinterpret_cast<const float2*>(
              Ss + ((k0 + kk) / group - r_lo) * SS);
        split<true>(code(v) * sc.x, fb[s][2 * h], fs[s][2 * h]);
        split<true>(code(v >> 8) * sc.y, fb[s][2 * h + 1], fs[s][2 * h + 1]);
      }
    const uint32_t base = static_cast<uint32_t>(
        __cvta_generic_to_shared(split_buf + (kt & 1) * 2 * SPLIT_FLOATS));
    const bool more = kt + STAGES - 1 < n_k, next = kt + 1 < n_k;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t db = desc_sw128(base + 32 * s);
      wgmma_tf32(d, fs[s], db, s > 0);
      if constexpr (X3)
        wgmma_tf32(d, fb[s], desc_sw128(base + 4 * SPLIT_FLOATS + 32 * s), 1);
      wgmma_tf32(d, fb[s], db, 1);
      // slot (kt - 1) % STAGES is free: its packed bytes and scales were
      // read before the last barrier and its A split the tile before;
      // split buffer (kt + 1) & 1 was last read by tile kt - 1's products,
      // waited for before it
      if (more) load_part(kt + STAGES - 1, (kt + STAGES - 1) % STAGES, s);
      if (next) split_part((kt + 1) % STAGES, (kt + 1) & 1, s);
    }
    wgmma_commit();
    cp_async_commit();
    if (next) fence_proxy_async();
    wgmma_wait_all();
    pin(d);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
    cp_async_wait<STAGES - 3>();  // tile kt + 2 has landed
    __syncthreads();
  }
  cp_async_wait<0>();

  // acc holds C^T: element 4 j + e is C[8 j + 2 t + (e & 1)][nc + (e >> 1)]
  // of the tile.  The non-finite rule: a tile with a non-finite output is
  // recomputed by the fp32 FMA loop (in the ring, whose copies have all
  // landed)
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = row0 + 8 * j + 2 * t + (e & 1);
      const int n = col0 + nc + (e >> 1);
      if (m < M && n < N && !isfinite(acc[4 * j + e])) bad = true;
    }
  if (__syncthreads_or(bad)) {
    if (tid == 0) atomicAdd(recomputes, 1);
    fma_tile(
        reinterpret_cast<float*>(ring), K, t, nc, nc + 1,
        [=](int r, int k) {
          return row0 + r < M && k < K
                     ? widen(A[(long long)(row0 + r) * K + k]) : 0.f;
        },
        [=](int k, int c) {
          const int n = col0 + c;
          if (k >= K || n >= N) return 0.f;
          return code(P[(long long)(k >> 1) * N + n] >> (4 * (k & 1))) *
                 S[(long long)(k / group) * N + n];
        },
        [=](int r, int c, float v) {
          if (row0 + r < M && col0 + c < N)
            C[(long long)(row0 + r) * N + col0 + c] = narrow<T>(v);
        });
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = row0 + 8 * j + 2 * t + (e & 1);
      const int n = col0 + nc + (e >> 1);
      if (m < M && n < N) C[(long long)m * N + n] = narrow<T>(acc[4 * j + e]);
    }
}

template <typename T, bool ONE_ROW>
int launch_one(const void* a, const void* p, const void* s, void* c, int batch,
           int M, int N, int K, int group, long long sa, long long sp,
           long long ss, long long sc, void* recomputes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      q4_panel_matmul<T, ONE_ROW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row start is aligned to them: A's rows of 4
  // elements (cp.async 16 / 8 bytes), the packed rows of 16 bytes, the
  // scale rows of 4 floats
  constexpr unsigned UNIT = 4 * sizeof(T);
  const int vec_a = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % UNIT == 0;
  const int vec_p = N % 16 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const int vec_s = N % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  q4_panel_matmul<T, ONE_ROW><<<grid, THREADS, SMEM_BYTES,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const uint8_t*>(p),
      static_cast<const float*>(s), static_cast<T*>(c), M, N, K, group, sa,
      sp, ss, sc, vec_a, vec_p, vec_s, static_cast<int*>(recomputes));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* p, const void* s, void* c, int batch,
           int M, int N, int K, int group, long long sa, long long sp,
           long long ss, long long sc, void* recomputes, void* stream) {
  return (group % BK == 0 ? launch_one<T, true> : launch_one<T, false>)(
      a, p, s, c, batch, M, N, K, group, sa, sp, ss, sc, recomputes, stream);
}

}  // namespace

// recomputes: one device int, incremented once per tile recomputed under
// the non-finite rule
extern "C" int repro_q4_matmul_f32(const void* a, const void* p,
                                   const void* s, void* c, int batch, int M,
                                   int N, int K, int group, long long sa,
                                   long long sp, long long ss, long long sc,
                                   void* recomputes, void* stream) {
  return launch<float>(a, p, s, c, batch, M, N, K, group, sa, sp, ss, sc,
                       recomputes, stream);
}

extern "C" int repro_q4_matmul_bf16(const void* a, const void* p,
                                    const void* s, void* c, int batch, int M,
                                    int N, int K, int group, long long sa,
                                    long long sp, long long ss, long long sc,
                                    void* recomputes, void* stream) {
  return launch<__nv_bfloat16>(a, p, s, c, batch, M, N, K, group, sa, sp, ss,
                               sc, recomputes, stream);
}
