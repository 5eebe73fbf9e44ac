// The gradient of the linear-recurrence scan for Hopper (sm_90a), per
// channel.  The forward (csrc/lru_scan.cu) is
//   h[b, t, c] = a[b, t, c] * h[b, t - 1, c] + x[b, t, c],   h[b, -1, c] = 0;
// given a, the forward's output h and the output's cotangent gh, this kernel
// runs the reverse scan
//   g[t] = gh[t] + a[t + 1] * g[t + 1],   g[T - 1] = gh[T - 1]
// and writes dx = g and, in the same pass, da[t] = g[t] * h[t - 1] (h[-1] =
// 0).  The TPU kernel it is the gradient of
// (src/repro/kernels/lru_scan.py::lru_scan_pallas) has no backward: the
// reference trains the RG-LRU through the autograd of lax.associative_scan.
// The port routes the prefill's forward through its kernel
// (repro_torch/models/rglru.py::rglru_scan), so training needs this one
// (kernels/ops.py::LruScan).  Same arithmetic rules as the forward: an fp32
// carry from 0, IEEE fmaf steps (no fast math), operands widened to fp32 as
// they are read, dx and da each rounded once to the operands' dtype.
//
// The design is the forward's run backwards in time, reading a shifted by
// one row; no operand is copied or flipped first.  Each CTA takes one (b,
// 64-channel tile, 128-step T-chunk) by an atomic ticket, chunks in reverse
// time order (the last chunk first), so a chunk's successor in time has
// always started before anyone waits on it.  The CTA:
//   1. stages its gh rows t0 .. t0 + nt - 1 and its a rows t0 + 1 .. t0 + nt
//      (zero past T) in shared memory with 16-byte cp.async copies;
//   2. forms the chunk's aggregate per channel from a zero carry at its end,
//      backwards: (A, X) = (prod a[t + 1], g at the chunk's first row), and
//      publishes it with a flag (the last chunk publishes its g at once, as
//      the inclusive carry);
//   3. looks back over the later chunks' flags: an aggregate composes into
//      the running suffix, (A_s, X_s) <- (A_s A_j, A_s X_j + X_s), and the
//      first inclusive carry G_j ends the walk with carry = A_s G_j + X_s;
//   4. publishes its own inclusive carry A carry + X;
//   5. rescans its tile backwards from that carry, one fmaf per step,
//      writing dx and da once each; h[t - 1] is read from global memory
//      there (coalesced, once), not staged.
// That is 20 bytes per f32 element (a, h, gh read once; dx, da written
// once), the bound's traffic, plus 12 bytes per channel and chunk of
// aggregates.  The last chunk's g is the sequential loop's bit for bit;
// earlier chunks start from a carry formed in another association
// (ref.lru_scan_bwd_chunked_emulated repeats it on the CPU), and where the
// look-back stopped may change the last bits from run to run.
//
// What bounds it: three FLOP per element against 20 bytes, so the card's
// memory rate (5 B T C 4 bytes / 3.35 TB/s).  B * ceil(C / 64) * ceil(T /
// 128) CTAs of 64 threads, 64 KB of shared memory each (f32), three to an
// SM, as in the forward.
//
// Scratch (the wrapper's): the forward's layout — a ticket and a flag per
// CTA, zeroed per launch by cudaMemsetAsync, then the aggregates and
// inclusive carries, (B, n_chunks, C) floats each.
//
// What it still gives up: TMA, persistent CTAs, h staged with the rest
// (its loads sit in the rescan's dependency-free stream, unrolled), and
// bf16 stores staged through shared memory.
//
// Operands are contiguous (B, T, C); any T and C (ragged edges masked; rows
// whose C is not a multiple of 16 bytes take element-wise loads).  Plain C
// entry points (no PyTorch headers) keep the build to one nvcc call; each
// returns the launch's CUDA error code.

#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::narrow;
using tf32x3::widen;

constexpr int CT = 64;        // channels per CTA, one per thread
constexpr int TT = 128;       // time steps per chunk
constexpr int THREADS = CT;
constexpr int AGG = 1, INCL = 2;  // flag states (0: nothing published)

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lru_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                        const T* __restrict__ gh, T* __restrict__ dx,
                        T* __restrict__ da, int B, int Tn, int C, int n_ct,
                        int n_chunks, int vec, int* __restrict__ ctl,
                        float* __restrict__ agg_a, float* __restrict__ agg_x,
                        float* __restrict__ incl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);  // [TT][CT]: a[t0 + r + 1]
  T* sg = sa + TT * CT;                    // [TT][CT]: gh[t0 + r]
  __shared__ int s_ticket, s_state;

  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(ctl, 1);
  __syncthreads();
  const int tile = s_ticket;
  const int per_chunk = B * n_ct;
  const int rev = tile / per_chunk;        // 0: the last chunk in time
  const int chunk = n_chunks - 1 - rev;
  const int b = tile % per_chunk / n_ct, c0 = tile % n_ct * CT;
  const int t0 = chunk * TT;
  const int nt = min(TT, Tn - t0);
  const long long base = ((long long)b * Tn + t0) * C + c0;

  // 1. stage gh and a shifted by one row: rows of CT channels in 16-byte
  // chunks, a past T as zeros
  constexpr int PER = 16 / sizeof(T);
  for (int q = tid; q < nt * (CT / PER); q += THREADS) {
    const int r = q / (CT / PER), cc = q % (CT / PER) * PER;
    const long long off = base + (long long)r * C + cc;
    const bool next = t0 + r + 1 < Tn;
    if (vec) {
      const bool ok = c0 + cc < C;
      cp_async16(sg + r * CT + cc, ok ? gh + off : gh, ok);
      cp_async16(sa + r * CT + cc, ok && next ? a + off + C : a,
                 ok && next);
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const bool ok = c0 + cc + e < C;
        sg[r * CT + cc + e] = ok ? gh[off + e] : narrow<T>(0.f);
        sa[r * CT + cc + e] = ok && next ? a[off + C + e] : narrow<T>(0.f);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. the chunk's aggregate for this thread's channel, backwards
  const int c = c0 + tid;
  const bool live = c < C;
  float A = 1.f, X = 0.f;
  for (int t = nt - 1; t >= 0; --t) {
    const float at = widen(sa[t * CT + tid]);
    X = fmaf(at, X, widen(sg[t * CT + tid]));
    A *= at;
  }
  const long long slot = ((long long)b * n_chunks + rev) * C + c;
  int* flag = ctl + 1 + tile;
  float carry = 0.f;
  if (rev > 0) {
    if (live) {
      agg_a[slot] = A;
      agg_x[slot] = X;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) store_release(flag, AGG);

    // 3. look back over the later chunks: (A_s, X_s) composes chunks
    // rev - 1 .. j + 1 of the reverse order
    float As = 1.f, Xs = 0.f;
    for (int j = rev - 1;; --j) {
      if (tid == 0) {
        const int* fj = flag - (rev - j) * per_chunk;
        int state;
        while ((state = load_acquire(fj)) == 0) {
        }
        s_state = state;
      }
      __syncthreads();
      const int state = s_state;
      __syncthreads();  // s_state is read before tid 0 writes it again
      const long long sj = ((long long)b * n_chunks + j) * C + c;
      if (state == INCL) {
        if (live) carry = fmaf(As, __ldcg(incl + sj), Xs);
        break;
      }
      if (live) {
        Xs = fmaf(As, __ldcg(agg_x + sj), Xs);
        As *= __ldcg(agg_a + sj);
      }
    }
  }
  // 4. the inclusive carry at the chunk's first row (the last chunk's is X)
  if (live) incl[slot] = rev > 0 ? fmaf(A, carry, X) : X;
  __threadfence();
  __syncthreads();
  if (tid == 0) store_release(flag, INCL);

  // 5. rescan backwards from the carry: dx = g, da = g * h[t - 1]
  if (!live) return;
  float g = carry;
#pragma unroll 8
  for (int t = nt - 1; t >= 0; --t) {
    const long long o = base + (long long)t * C + tid;
    const float hp = t0 + t > 0 ? widen(h[o - C]) : 0.f;
    g = fmaf(widen(sa[t * CT + tid]), g, widen(sg[t * CT + tid]));
    dx[o] = narrow<T>(g);
    da[o] = narrow<T>(g * hp);
  }
}

// scratch: [ticket, flag per tile] ints, padded to 16 bytes, then the
// aggregates' a, x and the inclusive carries, (B, n_chunks, C) floats each
long long scratch_bytes(int B, int Tn, int C) {
  const long long n_chunks = (Tn + TT - 1) / TT;
  const long long tiles = (long long)B * ((C + CT - 1) / CT) * n_chunks;
  return 4 * ((tiles + 1 + 3) / 4 * 4) + 4 * 3LL * B * n_chunks * C;
}

template <typename T>
int launch(const void* a, const void* h, const void* gh, void* dx, void* da,
           int B, int Tn, int C, void* scratch, long long scratch_size,
           void* stream) {
  if (B < 0 || Tn < 0 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * Tn * C == 0) return 0;
  const int n_ct = (C + CT - 1) / CT, n_chunks = (Tn + TT - 1) / TT;
  const long long tiles = (long long)B * n_ct * n_chunks;
  if (tiles >= 0x7fffffffLL || scratch_size < scratch_bytes(B, Tn, C))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * sizeof(T) * TT * CT;
  cudaError_t err = cudaFuncSetAttribute(
      lru_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* ctl = static_cast<int*>(scratch);
  const long long ints = (tiles + 1 + 3) / 4 * 4;
  float* agg_a = reinterpret_cast<float*>(ctl + ints);
  const long long per = (long long)B * n_chunks * C;
  err = cudaMemsetAsync(ctl, 0, sizeof(int) * (tiles + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = C % (16 / sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(gh) % 16 == 0;
  lru_scan_bwd_kernel<T><<<static_cast<unsigned>(tiles), THREADS, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(gh), static_cast<T*>(dx), static_cast<T*>(da), B,
      Tn, C, n_ct, n_chunks, vec, ctl, agg_a, agg_a + per, agg_a + 2 * per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: device memory of scratch_size bytes, at least scratch_bytes(B,
// T, C) (kernels/lru_scan.py::scratch_bytes computes the same; a smaller
// one is refused)
extern "C" int repro_lru_scan_bwd_f32(const void* a, const void* h,
                                      const void* gh, void* dx, void* da,
                                      int B, int T, int C, void* scratch,
                                      long long scratch_size, void* stream) {
  return launch<float>(a, h, gh, dx, da, B, T, C, scratch, scratch_size,
                       stream);
}

extern "C" int repro_lru_scan_bwd_bf16(const void* a, const void* h,
                                       const void* gh, void* dx, void* da,
                                       int B, int T, int C, void* scratch,
                                       long long scratch_size, void* stream) {
  return launch<__nv_bfloat16>(a, h, gh, dx, da, B, T, C, scratch,
                               scratch_size, stream);
}
