// The MoE block's row movements between token order and expert order, for
// Hopper (sm_90a): four row passes over (b, rows, d) operands, each batch
// entry b with its own tables (the tp ranks and folded members of the
// capacity path; b = 1 for the dropless path).
//
//   dispatch      buf[r]  = x[table[r]]   (table in [0, N]; walked as inv)
//   combine       y[t]    = sum_j g[t, j] * out[inv[t, j]]   (inv in [0, S])
//   combine_bwd   d_out[inv[t, j]] = g[t, j] * dy[t],  d_g[t, j] = <dy[t], out[inv[t, j]]>
//   dispatch_bwd  dx[t]   = sum_j d_buf[inv[t, j]]
//
// An index equal to the row count of what it indexes (N for the tokens,
// S = E * C for the expert buffers), or outside [0, rows), is the
// sentinel: a zero row where it is read from, no row where it is written
// to.  It replaces no TPU kernel: the reference moves these rows with
// XLA gathers and a scatter-add (src/repro/models/moe.py), and the port
// did so with ~70 PyTorch elementwise launches a block (a padded copy
// before each index_select, k strided multiplies and adds, and in the
// backward a zero-filled (N, k, d) gradient for each of the k slots).
//
// The sums are the plain composition's bit for bit: each token's k terms
// added in ascending j (the tables list a token's cells in ascending expert
// order), term by term with __fmul_rn and __fadd_rn (no FMA contraction),
// the first term taken as it is, a sentinel's zero row multiplied and
// added like any other, and in bf16 every product and sum rounded to bf16
// as PyTorch's bf16 tensor ops round them.  The gate's gradient d_g is a
// dot product of d terms: each lane adds its columns in ascending order
// with fmaf, then a butterfly over the warp's lanes, a fixed order, so two
// runs agree bit for bit (it is not the plain version's reduction, and is
// held to a float64 one instead).
//
// What bounds it: bytes.  Every entry reads each row it needs once and
// writes each output row once (a token's row, or its dy, is read once and
// kept in registers or L1 for its k slots); none computes more than a
// multiply-add per element.  At granite's dropless block (M = 8192 tokens,
// k = 8, d = 1536, f32) that is 0.45 GB for dispatch, combine and
// dispatch_bwd each and 0.86 GB for combine_bwd: 0.66 ms at 3.35 TB/s for
// the four.
//
// The design: one warp a token, four warps a CTA, no shared memory and no
// barrier.  A lane takes the row's 16-byte vectors lane, lane + 32, ...,
// four of them in flight at once (a row of 1536 f32 is 384 vectors: three
// rounds of four).  A token's k indices and gates sit one in each of the
// first k lanes (k <= 32) and reach the others by shuffles.  dispatch and
// combine_bwd walk a token's k slots through inv (table's inverse), so
// each buffer cell a slot reaches is written once, by the warp of that
// token, and the token's row is read from memory once (a walk over table
// would read it k times, from all over the tokens); the cells no slot
// reaches (a sentinel in table or back: a capacity buffer's empty cells)
// are zeroed by extra warps after the token warps, 32 cells a warp.  So no
// cell is written twice, nothing is zero-filled first, and there are no
// atomics.  Rows whose bytes are not a multiple of 16, or operands not
// 16-byte aligned, take element-wise loads.
//
// What it gives up: TMA bulk copies of whole rows, and fusing dispatch
// into the grouped product's A-tile loads (the product would read x
// through the table itself and buf would not exist).
//
// Plain C entry points (no PyTorch headers) keep the build to one nvcc
// call; each returns the launch's CUDA error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;              // tokens a CTA, a warp each
constexpr int THREADS = 32 * WARPS;
constexpr int U = 4;                  // vectors a lane keeps in flight
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Num;
template <>
struct Num<float> {
  __device__ __forceinline__ static float f(float x) { return x; }
  __device__ __forceinline__ static float t(float x) { return x; }
};
template <>
struct Num<__nv_bfloat16> {
  __device__ __forceinline__ static float f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 t(float x) {
    return __float2bfloat16_rn(x);
  }
};

// V elements of T moved as one load or store (16 bytes, or one element)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> zeros() {
  Pack<T, V> p;
#pragma unroll
  for (int e = 0; e < V; ++e) p.v[e] = Num<T>::t(0.0f);
  return p;
}

// rounded as the dtype's tensor op rounds (identity for f32)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Num<T>::f(Num<T>::t(x));
}

__device__ __forceinline__ bool inside(long long i, long long n) {
  return i >= 0 && i < n;
}

// The warps after a kernel's token warps: each takes 32 cells of dst and
// zeros the rows of those whose entry in cell_slot lies outside [0, n) (no
// slot reaches them: a capacity buffer's empty cells).
template <typename T, int V>
__device__ __forceinline__ void zero_empty(T* __restrict__ dst,
                                           const long long* __restrict__
                                               cell_slot,
                                           long long n, long long first,
                                           long long cells, int lane,
                                           int dv) {
  if (first >= cells) return;
  const long long cell = first + lane;
  const bool empty = cell < cells && !inside(cell_slot[cell], n);
  unsigned todo = __ballot_sync(FULL, empty);
  while (todo) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    Pack<T, V>* to = reinterpret_cast<Pack<T, V>*>(dst) + (first + l) * dv;
    for (int c = lane; c < dv; c += 32) to[c] = zeros<T, V>();
  }
}

// dispatch: warp t reads token t's row once and writes it to each of the
// cells inv[t, 0..k-1] of its batch entry's dst (n_dst rows); then the
// cells whose table entry is a sentinel are zeroed
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
scatter_rows(const T* __restrict__ x, const long long* __restrict__ inv,
             const long long* __restrict__ table, T* __restrict__ dst,
             long long rows, long long per, long long n_dst,
             long long cells, int k, int dv) {
  using P = Pack<T, V>;
  const long long warp = static_cast<long long>(blockIdx.x) * WARPS +
                         threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) {
    zero_empty<T, V>(dst, table, per, (warp - rows) * 32, cells, lane, dv);
    return;
  }
  const long long mine = lane < k ? inv[warp * k + lane] : n_dst;
  const P* from = reinterpret_cast<const P*>(x) + warp * dv;
  P* base = reinterpret_cast<P*>(dst) + (warp / per) * n_dst * dv;
  // every lane runs the same rounds, so the shuffles see the whole warp
  for (int c0 = lane; c0 - lane < dv; c0 += 32 * U) {
    P v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + 32 * u < dv) v[u] = from[c0 + 32 * u];
    for (int j = 0; j < k; ++j) {
      const long long s = __shfl_sync(FULL, mine, j);
      if (!inside(s, n_dst)) continue;       // the same for the whole warp
      P* to = base + s * dv;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c0 + 32 * u < dv) to[c0 + 32 * u] = v[u];
    }
  }
}

// combine (WEIGHTED) and dispatch_bwd: warp w sums the rows idx[w, 0..k-1]
// of its batch entry's src, in ascending j, each times w[w, j] if WEIGHTED
template <typename T, int V, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS)
ordered_sum(const T* __restrict__ src, const long long* __restrict__ idx,
            const T* __restrict__ w, T* __restrict__ dst, long long rows,
            long long per, long long n_src, int k, int dv) {
  using P = Pack<T, V>;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  long long mine = n_src;
  float gate = 0.0f;
  if (lane < k) {
    mine = idx[row * k + lane];
    if (WEIGHTED) gate = Num<T>::f(w[row * k + lane]);
  }
  const P* base = reinterpret_cast<const P*>(src) + (row / per) * n_src * dv;
  P* to = reinterpret_cast<P*>(dst) + row * dv;
  // every lane runs the same rounds, so the shuffles see the whole warp
  for (int c0 = lane; c0 - lane < dv; c0 += 32 * U) {
    float acc[U][V];
    for (int j = 0; j < k; ++j) {
      const long long s = __shfl_sync(FULL, mine, j);
      const float g = __shfl_sync(FULL, gate, j);
      const bool valid = inside(s, n_src);
      const P* from = base + (valid ? s : 0) * dv;
      P v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + 32 * u;
        v[u] = (valid && c < dv) ? from[c] : zeros<T, V>();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float x = Num<T>::f(v[u].v[e]);
          const float term = WEIGHTED ? rnd<T>(__fmul_rn(x, g)) : x;
          acc[u][e] = j == 0 ? term : rnd<T>(__fadd_rn(acc[u][e], term));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + 32 * u >= dv) continue;
      P out;
#pragma unroll
      for (int e = 0; e < V; ++e) out.v[e] = Num<T>::t(acc[u][e]);
      to[c0 + 32 * u] = out;
    }
  }
}

// combine_bwd: warps 0..rows-1 take a token each (its k slots: the
// gradient rows into d_src, the gate gradients into d_w); the warps after
// them zero the d_src rows of the cells that back marks empty, 32 cells a
// warp
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
combine_bwd(const T* __restrict__ dy, const T* __restrict__ w,
            const long long* __restrict__ idx, const T* __restrict__ src,
            const long long* __restrict__ back, T* __restrict__ d_src,
            T* __restrict__ d_w, long long rows, long long per,
            long long n_src, long long cells, int k, int dv) {
  using P = Pack<T, V>;
  const long long warp = static_cast<long long>(blockIdx.x) * WARPS +
                         threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) {
    zero_empty<T, V>(d_src, back, per * k, (warp - rows) * 32, cells, lane,
                     dv);
    return;
  }
  const long long row = warp;
  long long mine = n_src;
  float gate = 0.0f;
  if (lane < k) {
    mine = idx[row * k + lane];
    gate = Num<T>::f(w[row * k + lane]);
  }
  const long long base = (row / per) * n_src;
  const P* grad = reinterpret_cast<const P*>(dy) + row * dv;
  for (int j = 0; j < k; ++j) {
    const long long s = __shfl_sync(FULL, mine, j);
    const float g = __shfl_sync(FULL, gate, j);
    float dot = 0.0f;
    if (inside(s, n_src)) {                 // the same for the whole warp
      const P* from = reinterpret_cast<const P*>(src) + (base + s) * dv;
      P* to = reinterpret_cast<P*>(d_src) + (base + s) * dv;
      for (int c0 = lane; c0 - lane < dv; c0 += 32 * U) {
        P a[U], o[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + 32 * u;
          if (c < dv) {
            a[u] = grad[c];
            o[u] = from[c];
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (c0 + 32 * u >= dv) continue;
          P out;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float x = Num<T>::f(a[u].v[e]);
            out.v[e] = Num<T>::t(__fmul_rn(x, g));
            dot = fmaf(x, Num<T>::f(o[u].v[e]), dot);
          }
          to[c0 + 32 * u] = out;
        }
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) dot += __shfl_xor_sync(FULL, dot, m);
    if (lane == 0) d_w[row * k + j] = Num<T>::t(dot);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte vectors where every row and pointer allows them
template <typename T>
bool vec_ok(int d, const void* a, const void* b, const void* c = nullptr) {
  return (d * static_cast<int>(sizeof(T))) % 16 == 0 && aligned16(a) &&
         aligned16(b) && (c == nullptr || aligned16(c));
}

unsigned grid_of(long long warps) {
  return static_cast<unsigned>((warps + WARPS - 1) / WARPS);
}

constexpr long long MAX_CTAS = 2147483647LL;

template <typename T>
int dispatch(const void* x, const void* inv, const void* table, void* buf,
             long long b, long long N, long long R, int k, int d,
             void* stream) {
  const long long rows = b * N, cells = b * R;
  const long long warps = rows + (cells + 31) / 32;
  if (cells == 0 || d == 0) return 0;
  if (k < 1 || k > 32 || (warps + WARPS - 1) / WARPS > MAX_CTAS)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* from = static_cast<const T*>(x);
  const long long* slots = static_cast<const long long*>(inv);
  const long long* tokens = static_cast<const long long*>(table);
  T* to = static_cast<T*>(buf);
  constexpr int V = 16 / sizeof(T);
  if (vec_ok<T>(d, x, buf))
    scatter_rows<T, V><<<grid_of(warps), THREADS, 0, s>>>(
        from, slots, tokens, to, rows, N, R, cells, k, d / V);
  else
    scatter_rows<T, 1><<<grid_of(warps), THREADS, 0, s>>>(
        from, slots, tokens, to, rows, N, R, cells, k, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool WEIGHTED>
int sum_rows(const void* src, const void* inv, const void* g, void* y,
             long long b, long long N, long long S, int k, int d,
             void* stream) {
  const long long rows = b * N;
  if (rows == 0 || d == 0) return 0;
  if (k < 1 || k > 32 || (rows + WARPS - 1) / WARPS > MAX_CTAS)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* from = static_cast<const T*>(src);
  const long long* idx = static_cast<const long long*>(inv);
  const T* w = static_cast<const T*>(g);
  T* to = static_cast<T*>(y);
  constexpr int V = 16 / sizeof(T);
  if (vec_ok<T>(d, src, y))
    ordered_sum<T, V, WEIGHTED><<<grid_of(rows), THREADS, 0, s>>>(
        from, idx, w, to, rows, N, S, k, d / V);
  else
    ordered_sum<T, 1, WEIGHTED><<<grid_of(rows), THREADS, 0, s>>>(
        from, idx, w, to, rows, N, S, k, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine_backward(const void* dy, const void* g, const void* inv,
                     const void* src, const void* back, void* d_src,
                     void* d_g, long long b, long long N, long long S, int k,
                     int d, void* stream) {
  const long long rows = b * N, cells = b * S;
  const long long warps = rows + (cells + 31) / 32;
  if (warps == 0) return 0;
  if (k < 1 || k > 32 || (warps + WARPS - 1) / WARPS > MAX_CTAS)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = 16 / sizeof(T);
  const T* grad = static_cast<const T*>(dy);
  const T* w = static_cast<const T*>(g);
  const long long* idx = static_cast<const long long*>(inv);
  const T* from = static_cast<const T*>(src);
  const long long* cell_slot = static_cast<const long long*>(back);
  T* to = static_cast<T*>(d_src);
  T* d_w = static_cast<T*>(d_g);
  if (vec_ok<T>(d, dy, src, d_src))
    combine_bwd<T, V><<<grid_of(warps), THREADS, 0, s>>>(
        grad, w, idx, from, cell_slot, to, d_w, rows, N, S, cells, k, d / V);
  else
    combine_bwd<T, 1><<<grid_of(warps), THREADS, 0, s>>>(
        grad, w, idx, from, cell_slot, to, d_w, rows, N, S, cells, k, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes (all contiguous; indices int64): x (b, N, d), table (b, R), buf
// (b, R, d), dispatch's inv (b, N, k) into buf's R cells; src / out (b, S,
// d), inv and g (b, N, k), y / dy / dx (b, N, d), back (b, S), d_g (b, N,
// k).  A sentinel index is the row count of what it indexes (N, R, S; N * k
// for back).  table, inv and back describe one routing: inv[t, j] = r
// exactly where table[r] = t and back[r] = t * k + j.
extern "C" int repro_moe_dispatch_f32(const void* x, const void* inv,
                                      const void* table, void* buf,
                                      long long b, long long N, long long R,
                                      int k, int d, void* stream) {
  return dispatch<float>(x, inv, table, buf, b, N, R, k, d, stream);
}

extern "C" int repro_moe_dispatch_bf16(const void* x, const void* inv,
                                       const void* table, void* buf,
                                       long long b, long long N, long long R,
                                       int k, int d, void* stream) {
  return dispatch<__nv_bfloat16>(x, inv, table, buf, b, N, R, k, d, stream);
}

extern "C" int repro_moe_combine_f32(const void* src, const void* inv,
                                     const void* g, void* y, long long b,
                                     long long N, long long S, int k, int d,
                                     void* stream) {
  return sum_rows<float, true>(src, inv, g, y, b, N, S, k, d, stream);
}

extern "C" int repro_moe_combine_bf16(const void* src, const void* inv,
                                      const void* g, void* y, long long b,
                                      long long N, long long S, int k, int d,
                                      void* stream) {
  return sum_rows<__nv_bfloat16, true>(src, inv, g, y, b, N, S, k, d,
                                       stream);
}

extern "C" int repro_moe_combine_bwd_f32(const void* dy, const void* g,
                                         const void* inv, const void* src,
                                         const void* back, void* d_src,
                                         void* d_g, long long b, long long N,
                                         long long S, int k, int d,
                                         void* stream) {
  return combine_backward<float>(dy, g, inv, src, back, d_src, d_g, b, N, S,
                                 k, d, stream);
}

extern "C" int repro_moe_combine_bwd_bf16(const void* dy, const void* g,
                                          const void* inv, const void* src,
                                          const void* back, void* d_src,
                                          void* d_g, long long b,
                                          long long N, long long S, int k,
                                          int d, void* stream) {
  return combine_backward<__nv_bfloat16>(dy, g, inv, src, back, d_src, d_g,
                                         b, N, S, k, d, stream);
}

extern "C" int repro_moe_dispatch_bwd_f32(const void* d_buf, const void* inv,
                                          void* dx, long long b, long long N,
                                          long long S, int k, int d,
                                          void* stream) {
  return sum_rows<float, false>(d_buf, inv, nullptr, dx, b, N, S, k, d,
                                stream);
}

extern "C" int repro_moe_dispatch_bwd_bf16(const void* d_buf,
                                           const void* inv, void* dx,
                                           long long b, long long N,
                                           long long S, int k, int d,
                                           void* stream) {
  return sum_rows<__nv_bfloat16, false>(d_buf, inv, nullptr, dx, b, N, S, k,
                                        d, stream);
}
