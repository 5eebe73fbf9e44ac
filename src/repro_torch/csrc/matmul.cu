// Panel matmul on Hopper's tensor cores (sm_90a): C[z] = A[z] @ B[z].
//
// Replaces the TPU kernel src/repro/kernels/matmul.py::matmul_pallas, the
// SUMMA panel product of the paper's §5.2.1.  On the TPU a sequential k grid
// axis carried a (block_m, block_n) fp32 accumulator in VMEM scratch and wrote
// it out on the last k step.  Here blocks run in parallel with no order, so
// each block owns one 128x128 output tile for its whole life, walks K in 32-
// deep tiles and keeps its fp32 accumulators in registers, written once.
//
// What bounds it: at the SUMMA panel shape (4096^3 per rank, f32) the work
// is 2*4096^3 FLOP against 3*64 MiB of traffic, ~700 FLOP per byte, so
// arithmetic bounds it.  f32 runs as 3xTF32 (tf32x3.cuh): three TF32
// tensor-core products per fragment, big.big + big.small + small.big, with
// fp32 accumulators, about as accurate as the fp32 FMA loop (its in-order
// sum of K / 32 tile sums walks as sqrt(K): at K 151,936 2.2-2.4x
// torch.matmul's f32 error, kernels/matmul.py).  Its least time is
// 3 x FLOP at the card's 495 TFLOP/s TF32 rate (13.3 ms for a SUMMA round
// of 16 panels), against FLOP at 67 TFLOP/s for the fp32 FMA loop on the
// CUDA cores (32.8 ms).  bf16 operands are exact in TF32 and take the one
// big.big product; the output is rounded once to the input dtype.
//
// Design: warpgroup products (wgmma.mma_async m64n128k8 .tf32), which take
// their B operand K-major from shared memory and, for TF32, cannot
// transpose it.  A is K-major already, B is not, so each block computes its
// tile transposed, C^T = B^T A^T: the A tile is the shared operand and B^T
// the register operand.  256 threads, two warpgroups of 64 C columns each.
// Raw A (128 x 32) and B (32 x 128) tiles stream through a 4-stage ring of
// cp.async copies, 16 bytes of f32 or 8 of bf16 (zero-filled past the
// ragged M / N / K edges); bf16 stays bf16 in the ring and is widened where
// it is split.
// Once per tile the block splits the raw A tile into big and small tiles
// (double-buffered) in wgmma's 128-byte swizzle; each warp splits its B^T
// fragments in registers.  A tile's 12 products (4 k-steps x 3) are issued
// back to back, with a quarter of the copies of the tile 3 ahead and of the
// next tile's split after each k-step, so that work runs while the tensor
// cores do.  The tensor cores truncate as they accumulate, so the 12
// products sum from zero into a second set of registers, which is added
// into the fp32 accumulator with IEEE adds once per tile (accumulating all
// of K in the tensor cores made the product several times less accurate
// than torch.matmul; chip_smoke.py prints both against a float64 product).
// One barrier per tile; 197 KB of dynamic shared memory, one block per SM.
// Rows that do not start 16-byte aligned (K or N not a multiple of 4, or an
// unaligned base) take a guarded element-wise load into the same ring.
// Stores are guarded.  Non-finite and near-max operands follow the rule of
// tf32x3.cuh: a block whose tile holds a non-finite output recomputes it
// with the fp32 FMA loop and counts that in *recomputes, so the result is
// the IEEE product's (+-inf and NaN where it has them).  The check is one
// isfinite per output and one barrier per tile.
//
// What it still gives up: TMA with mbarriers and a producer warp (warp
// specialisation), a persistent tile schedule with the epilogue overlapped,
// thread block clusters sharing tiles, and split-K.
//
// Layouts.  C is row-major (M, N); the operands are given row-major as
//   NN: A (M, K), B (K, N)   C = A B      (a forward product; SUMMA's panels)
//   NT: A (M, K), B (N, K)   C = A B^T    (dX = dY W^T of a product X W)
//   TN: A (K, M), B (K, N)   C = A^T B    (dW = X^T dY)
// so a product's gradients read its operands where they lie: no transposed
// copy of either is made.  Each transposition is folded into a step that
// rewrites a tile already.  TN's raw A tile arrives k-rows of 128 m
// (32 x 128) and the per-tile split writes it out K-major into the
// swizzled big / small tiles, each lane taking one m row (its four column
// reads and its swizzled store are free of bank conflicts).  NT's raw B
// tile arrives n-rows of 32 k (128 x 36, the pad keeping the reads
// conflict-free) and the B^T register fragments are read from it along its
// rows.  NN is the layout described above; NT's ring stage holds 256 floats
// more (201 KB in all).  The non-finite rule holds in every layout.
//
// Operands are contiguous per batch entry; blockIdx.z walks an optional
// leading batch, so one launch covers every rank's panel product of a
// SUMMA round.
//
// The grouped entry (grouped_matmul) runs the same tile loop over the
// experts of a dropless MoE block: the routed rows sorted by expert into
// segments whose offsets stay on the device, each segment times its own
// expert's matrix (NN forward, NT dX), or each expert's dW from its own
// segment's rows (TN, the rows its depth).  A block finds its segment from
// the offsets, so no host read and no padding to a capacity is needed.  It
// gives up a schedule that balances uneven segments: a segment's last row
// tile may be mostly empty, and a long segment in TN is one deep loop.
//
// Plain C entry points (no PyTorch headers) keep the build to
// one nvcc call; each returns the launch's CUDA error code.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

enum Layout : int { NN = 0, NT = 1, TN = 2 };

constexpr int BM = 128;      // C rows per block (the wgmma's N)
constexpr int BN = 128;      // C columns: 2 warpgroups x 64 (the wgmma's M)
constexpr int BK = 32;       // one 128-byte swizzle row of f32
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int SB = BN + 8;                   // raw B row stride (floats):
                                             // fragment reads conflict-free
constexpr int SBT = BK + 4;                  // NT's raw (n, k) B row stride
constexpr int RAW_A = BM * BK;               // raw A tile, rows of 128 bytes
                                             // (TN: 32 rows of 128 floats)
constexpr int SPLIT_FLOATS = BM * BK;        // one swizzled 16 KB tile

// one ring stage (bf16 fills half): the raw A tile, then the raw B tile
template <int L>
__host__ __device__ constexpr int raw_floats() {
  return RAW_A + (L == NT ? BN * SBT : BK * SB);
}
// [big 0][small 0][big 1][small 1] (1024-byte aligned) then the ring
template <int L>
__host__ __device__ constexpr int smem_bytes() {
  return sizeof(float) * (4 * SPLIT_FLOATS + STAGES * raw_floats<L>()) +
         1024;
}

// The tile loop every entry runs: the 128 x 128 tile of C = op(A) op(B)
// (C row-major (M, N), the product K deep) whose corner is (row0, col0)
template <typename T, int L>
__device__ __forceinline__ void tile_product(
    const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
    int M, int N, int K, int row0, int col0, int vec_a, int vec_b,
    int* __restrict__ recomputes) {
  constexpr bool X3 = std::is_same<T, float>::value;
  constexpr int RAW_FLOATS = raw_floats<L>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* split_buf = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* ring = split_buf + 4 * SPLIT_FLOATS;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nw = 64 * (warp >> 2) + 16 * (warp & 3);  // the warp's columns
  const int n_k = (K + BK - 1) / BK;

  // quarter i of tile kt into ring slot s: chunk tid + 256 i of A and of B,
  // rows read coalesced.  A: 128 rows x 8 chunks of 4 (TN: 32 k-rows x 32
  // chunks); B: 32 rows x 32 chunks (NT: 128 n-rows x 8 chunks)
  auto load_part = [&](int kt, int s, int i) {
    T* As = reinterpret_cast<T*>(ring + s * RAW_FLOATS);
    T* Bs = As + RAW_A;
    const int k0 = kt * BK;
    const int q = tid + i * THREADS;
    if constexpr (L == TN) {
      const int r = q >> 5, mc = row0 + (q & 31) * 4;
      const int gk = k0 + r;
      T* dst = As + r * BM + (q & 31) * 4;
      if (vec_a) {
        const bool ok = gk < K && mc < M;
        copy4(dst, ok ? A + (long long)gk * M + mc : A, ok);
      } else {
        load4_guarded(dst, A + (long long)gk * M, mc, gk < K ? M : 0);
      }
    } else {
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
    if constexpr (L == NT) {
      const int r = q >> 3, kc = k0 + (q & 7) * 4;
      const int gn = col0 + r;
      T* dst = Bs + r * SBT + (q & 7) * 4;
      if (vec_b) {
        const bool ok = gn < N && kc < K;
        copy4(dst, ok ? B + (long long)gn * K + kc : B, ok);
      } else {
        load4_guarded(dst, B + (long long)gn * K, kc, gn < N ? K : 0);
      }
    } else {
      const int r = q >> 5, nc = col0 + (q & 31) * 4;
      const int gk = k0 + r;
      T* dst = Bs + r * SB + (q & 31) * 4;
      if (vec_b) {
        const bool ok = gk < K && nc < N;
        copy4(dst, ok ? B + (long long)gk * N + nc : B, ok);
      } else {
        load4_guarded(dst, B + (long long)gk * N, nc, gk < K ? N : 0);
      }
    }
  };

  // quarter i of the raw A tile in slot s -> big / small tiles of split
  // buffer `buf`, 16-byte chunk c of row r at chunk c ^ (r % 8) (the
  // 128-byte swizzle).  TN transposes here: row r's chunk c is column r of
  // the raw tile's k-rows 4 c .. 4 c + 3
  auto split_part = [&](int s, int buf, int i) {
    const T* raw = reinterpret_cast<const T*>(ring + s * RAW_FLOATS);
    float* big = split_buf + buf * 2 * SPLIT_FLOATS;
    const int q = tid + i * THREADS;
    int r, c;
    float4 x;
    if constexpr (L == TN) {
      r = q & (BM - 1);
      c = q >> 7;
      const T* p = raw + 4 * c * BM + r;
      x = make_float4(widen(p[0]), widen(p[BM]), widen(p[2 * BM]),
                      widen(p[3 * BM]));
    } else {
      r = q >> 3;
      c = q & 7;
      x = read4(raw + r * BK + c * 4);
    }
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
    // B^T fragments of the tile's 4 k-steps (the m16n8k8 A layout:
    // B[k0 + 8 s + t (+4)][nw + g (+8)]; NT reads B^T[n][k] along its rows)
    uint32_t fb[4][4], fs[4][4];
    const T* Bs = reinterpret_cast<const T*>(ring + (kt % STAGES) *
                                                        RAW_FLOATS) +
                  RAW_A;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if constexpr (L == NT) {
        const T* p = Bs + (nw + g) * SBT + 8 * s + t;
        split_exact<X3>(widen(p[0]), fb[s][0], fs[s][0]);
        split_exact<X3>(widen(p[8 * SBT]), fb[s][1], fs[s][1]);
        split_exact<X3>(widen(p[4]), fb[s][2], fs[s][2]);
        split_exact<X3>(widen(p[8 * SBT + 4]), fb[s][3], fs[s][3]);
      } else {
        const T* p = Bs + (8 * s + t) * SB + nw + g;
        split_exact<X3>(widen(p[0]), fb[s][0], fs[s][0]);
        split_exact<X3>(widen(p[8]), fb[s][1], fs[s][1]);
        split_exact<X3>(widen(p[4 * SB]), fb[s][2], fs[s][2]);
        split_exact<X3>(widen(p[4 * SB + 8]), fb[s][3], fs[s][3]);
      }
    }
    const uint32_t base = static_cast<uint32_t>(
        __cvta_generic_to_shared(split_buf + (kt & 1) * 2 * SPLIT_FLOATS));
    const bool more = kt + STAGES - 1 < n_k, next = kt + 1 < n_k;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t db = desc_sw128(base + 32 * s);
      if constexpr (X3) {
        const uint64_t ds = desc_sw128(base + 4 * SPLIT_FLOATS + 32 * s);
        wgmma_tf32(d, fs[s], db, s > 0);
        wgmma_tf32(d, fb[s], ds, 1);
        wgmma_tf32(d, fb[s], db, 1);
      } else {
        wgmma_tf32(d, fb[s], db, s > 0);
      }
      // slot (kt - 1) % STAGES is free: its B was read before the last
      // barrier and its A split the tile before; split buffer (kt + 1) & 1
      // was last read by tile kt - 1's products, waited for before it
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

  // acc holds C^T: element 4 j + e is C[8 j + 2 t + (e & 1)][nw + g +
  // 8 (e >> 1)] of the tile.  The non-finite rule: a tile with a
  // non-finite output is recomputed by the fp32 FMA loop (in the ring,
  // whose copies have all landed)
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = row0 + 8 * j + 2 * t + (e & 1);
      const int n = col0 + nw + g + 8 * (e >> 1);
      if (m < M && n < N && !isfinite(acc[4 * j + e])) bad = true;
    }
  if (__syncthreads_or(bad)) {
    if (tid == 0) atomicAdd(recomputes, 1);
    fma_tile(
        ring, K, t, nw + g, nw + g + 8,
        [=](int r, int k) {
          if (row0 + r >= M || k >= K) return 0.f;
          return widen(L == TN ? A[(long long)k * M + row0 + r]
                               : A[(long long)(row0 + r) * K + k]);
        },
        [=](int k, int c) {
          if (k >= K || col0 + c >= N) return 0.f;
          return widen(L == NT ? B[(long long)(col0 + c) * K + k]
                               : B[(long long)k * N + col0 + c]);
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
      const int n = col0 + nw + g + 8 * (e >> 1);
      if (m < M && n < N) C[(long long)m * N + n] = narrow<T>(acc[4 * j + e]);
    }
}

template <typename T, int L>
__global__ void __launch_bounds__(THREADS, 1)
    panel_matmul(const T* __restrict__ A, const T* __restrict__ B,
                 T* __restrict__ C, int M, int N, int K, long long sa,
                 long long sb, long long sc, int vec_a, int vec_b,
                 int* __restrict__ recomputes) {
  tile_product<T, L>(A + blockIdx.z * sa, B + blockIdx.z * sb,
                     C + blockIdx.z * sc, M, N, K, blockIdx.y * BM,
                     blockIdx.x * BN, vec_a, vec_b, recomputes);
}

// The grouped entry: G products over the segments of a row-sorted operand,
// segment g its rows [off[g], off[g + 1]) (off: G + 1 ints on the device,
// from 0 up to the rows in all, R; a segment may be empty)
//   NN: A (R, K), B (G, K, N), C (R, N)     C_g = A_g B[g]
//   NT: A (R, K), B (G, N, K), C (R, N)     C_g = A_g B[g]^T
//   TN: A (R, M), B (R, N), C (G, M, N)     C[g] = A_g^T B_g (K_g: its rows)
// NN / NT: blockIdx.y walks the segments' row tiles in order; the grid has
// ceil(R / BM) + G of them, the most that G segments of R rows can need,
// and a block past the last exits.  TN: blockIdx.z is the segment, whose
// rows are the product's depth; an empty one writes zeros.
template <typename T, int L>
__global__ void __launch_bounds__(THREADS, 1)
    grouped_matmul(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ C, const int* __restrict__ off, int G,
                   int M, int N, int K, int vec_a, int vec_b,
                   int* __restrict__ recomputes) {
  if constexpr (L == TN) {
    const int g = blockIdx.z;
    const int lo = off[g];
    tile_product<T, L>(A + (long long)lo * M, B + (long long)lo * N,
                       C + (long long)g * M * N, M, N, off[g + 1] - lo,
                       blockIdx.y * BM, blockIdx.x * BN, vec_a, vec_b,
                       recomputes);
  } else {
    int tile = blockIdx.y, g = 0, lo = 0, rows = 0;
    for (; g < G; ++g) {
      lo = off[g];
      rows = off[g + 1] - lo;
      const int tiles = (rows + BM - 1) / BM;
      if (tile < tiles) break;
      tile -= tiles;
    }
    if (g == G) return;
    tile_product<T, L>(A + (long long)lo * K, B + (long long)g * K * N,
                       C + (long long)lo * N, rows, N, K, tile * BM,
                       blockIdx.x * BN, vec_a, vec_b, recomputes);
  }
}

// a row's 4 elements are one 16-byte (f32) / 8-byte (bf16) cp.async when
// every row start is aligned to it; A's rows run along K (TN: M), B's along
// N (NT: K).  A grouped operand's segments start on such rows
template <typename T, int L>
void row_vectors(const void* a, const void* b, int M, int N, int K,
                 int* vec_a, int* vec_b) {
  constexpr unsigned UNIT = 4 * sizeof(T);
  const int a_row = L == TN ? M : K, b_row = L == NT ? K : N;
  *vec_a = a_row % 4 == 0 && reinterpret_cast<uintptr_t>(a) % UNIT == 0;
  *vec_b = b_row % 4 == 0 && reinterpret_cast<uintptr_t>(b) % UNIT == 0;
}

template <typename T, int L>
int launch_grouped(const void* a, const void* b, void* c, const void* off,
                   int G, int M, int N, int K, void* recomputes,
                   void* stream) {
  constexpr int SMEM_BYTES = smem_bytes<L>();
  cudaError_t err = cudaFuncSetAttribute(
      grouped_matmul<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int vec_a, vec_b;
  row_vectors<T, L>(a, b, M, N, K, &vec_a, &vec_b);
  const dim3 grid = L == TN ? dim3((N + BN - 1) / BN, (M + BM - 1) / BM, G)
                            : dim3((N + BN - 1) / BN, (M + BM - 1) / BM + G);
  grouped_matmul<T, L><<<grid, THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<const int*>(off), G, M, N, K, vec_a, vec_b,
      static_cast<int*>(recomputes));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L>
int launch(const void* a, const void* b, void* c, int batch, int M, int N,
           int K, long long sa, long long sb, long long sc, void* recomputes,
           void* stream) {
  constexpr int SMEM_BYTES = smem_bytes<L>();
  cudaError_t err = cudaFuncSetAttribute(
      panel_matmul<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int vec_a, vec_b;
  row_vectors<T, L>(a, b, M, N, K, &vec_a, &vec_b);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  panel_matmul<T, L><<<grid, THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K, sa, sb, sc, vec_a, vec_b, static_cast<int*>(recomputes));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_layout(int layout, const void* a, const void* b, void* c,
                  int batch, int M, int N, int K, long long sa, long long sb,
                  long long sc, void* recomputes, void* stream) {
  switch (layout) {
    case NN:
      return launch<T, NN>(a, b, c, batch, M, N, K, sa, sb, sc, recomputes,
                           stream);
    case NT:
      return launch<T, NT>(a, b, c, batch, M, N, K, sa, sb, sc, recomputes,
                           stream);
    case TN:
      return launch<T, TN>(a, b, c, batch, M, N, K, sa, sb, sc, recomputes,
                           stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int grouped_layout(int layout, const void* a, const void* b, void* c,
                   const void* off, int G, int M, int N, int K,
                   void* recomputes, void* stream) {
  switch (layout) {
    case NN:
      return launch_grouped<T, NN>(a, b, c, off, G, M, N, K, recomputes,
                                   stream);
    case NT:
      return launch_grouped<T, NT>(a, b, c, off, G, M, N, K, recomputes,
                                   stream);
    case TN:
      return launch_grouped<T, TN>(a, b, c, off, G, M, N, K, recomputes,
                                   stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C = op(A) op(B) in `layout` (0 NN, 1 NT, 2 TN; C is (M, N), the product
// K deep); recomputes: one device int, incremented once per tile
// recomputed under the non-finite rule
extern "C" int repro_matmul_f32(int layout, const void* a, const void* b,
                                void* c, int batch, int M, int N, int K,
                                long long sa, long long sb, long long sc,
                                void* recomputes, void* stream) {
  return launch_layout<float>(layout, a, b, c, batch, M, N, K, sa, sb, sc,
                              recomputes, stream);
}

extern "C" int repro_matmul_bf16(int layout, const void* a, const void* b,
                                 void* c, int batch, int M, int N, int K,
                                 long long sa, long long sb, long long sc,
                                 void* recomputes, void* stream) {
  return launch_layout<__nv_bfloat16>(layout, a, b, c, batch, M, N, K, sa,
                                      sb, sc, recomputes, stream);
}

// The grouped entry (grouped_matmul above) in `layout`; NN / NT: M is the
// rows of A and C in all; TN: K is the rows of A and B in all.  off: G + 1
// device ints
extern "C" int repro_grouped_matmul_f32(int layout, const void* a,
                                        const void* b, void* c,
                                        const void* off, int G, int M, int N,
                                        int K, void* recomputes,
                                        void* stream) {
  return grouped_layout<float>(layout, a, b, c, off, G, M, N, K, recomputes,
                               stream);
}

extern "C" int repro_grouped_matmul_bf16(int layout, const void* a,
                                         const void* b, void* c,
                                         const void* off, int G, int M,
                                         int N, int K, void* recomputes,
                                         void* stream) {
  return grouped_layout<__nv_bfloat16>(layout, a, b, c, off, G, M, N, K,
                                       recomputes, stream);
}
