// Linear-recurrence scan for Hopper (sm_90a), elementwise over channels:
//   h[b, t, c] = a[b, t, c] * h[b, t - 1, c] + x[b, t, c],   h[b, -1, c] = 0
//
// Replaces the TPU kernel src/repro/kernels/lru_scan.py::lru_scan_pallas,
// the RG-LRU recurrence of every rglru block's prefill
// (repro_torch/models/rglru.py::rglru_scan, called with a = exp(log_a)).
// Same function: an fp32 carry from 0, IEEE fmaf steps (no fast math), a
// and x widened to fp32 as they are read, each h rounded once to x's dtype
// when stored.
//
// On the TPU the time axis was an "arbitrary" grid dimension with the carry
// in a VMEM scratch that persisted across its steps.  Hopper's blocks run
// in no order, so the carry is passed forward between them instead, in one
// pass (a decoupled look-back scan).  Each CTA takes one (b, 64-channel
// tile, 128-step T-chunk) by an atomic ticket, chunk-major, so a chunk's
// predecessor has always started before anyone waits on it (no deadlock,
// whatever order the CTAs are scheduled in).  The CTA:
//   1. stages its a and x tiles in shared memory with 16-byte cp.async
//      copies issued all at once (64 KB in flight per f32 CTA, three CTAs
//      per SM: Little's law asks ~3 MB in flight of the card, 3.35 TB/s x
//      ~1 us);
//   2. forms the chunk's aggregate per channel from a zero carry:
//      (A, X) = (prod a_t, h at the chunk's end), and publishes it with a
//      flag (chunk 0 publishes its end h as the inclusive carry at once);
//   3. looks back over the predecessors' flags: an aggregate composes into
//      the running suffix, (A_s, X_s) <- (A_s A_j, A_s X_j + X_s), and the
//      first inclusive carry H_j ends the walk with carry = A_s H_j + X_s;
//   4. publishes its own inclusive carry A carry + X;
//   5. rescans its tile from that carry, one fmaf per step, writing each h
//      once.
// That is 12 bytes per f32 element, the bound's traffic, plus 12 bytes
// per channel and chunk of aggregates.  Chunk 0's h is the sequential
// loop's bit for bit; later chunks start from a carry formed in another
// association, so they agree with it within rounding, and where the
// look-back stopped (one hop or several) may change the last bits from run
// to run.  a = 1 with integer x stays exact (a cumsum).
//
// What bounds it: one FMA per element against 12 bytes (f32: a and x read
// once, h written once), so the card's memory rate (3 B T C 4 bytes / 3.35
// TB/s).  B * ceil(C / 64) * ceil(T / 128) CTAs of 64 threads: 6,144 at
// phase 9's largest prefill group (4, 3071, 4096), 1,536 for a lone
// 3072-token prompt (B = 1), so a lone prompt fills the card too.  The
// tile was chosen on the card among 64 / 128 channels x 32 / 64 / 128
// steps: longer chunks cut the look-back, and 64 KB (f32) still lets three
// CTAs share an SM.
//
// Scratch (the wrapper's): a ticket and a flag per CTA, zeroed per launch
// by cudaMemsetAsync, then the aggregates and inclusive carries, (B,
// n_chunks, C) floats each, which need no reset.
//
// What it still gives up: TMA, persistent CTAs that prefetch their next
// tile while they scan, and bf16 stores staged through shared memory.
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
    lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                    T* __restrict__ h, int B, int Tn, int C, int n_ct,
                    int n_chunks, int vec, int* __restrict__ ctl,
                    float* __restrict__ agg_a, float* __restrict__ agg_x,
                    float* __restrict__ incl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);  // [TT][CT]
  T* sx = sa + TT * CT;
  __shared__ int s_ticket, s_state;

  const int tid = threadIdx.x;
  if (tid == 0) s_ticket = atomicAdd(ctl, 1);
  __syncthreads();
  const int tile = s_ticket;
  const int per_chunk = B * n_ct;
  const int chunk = tile / per_chunk;
  const int b = tile % per_chunk / n_ct, c0 = tile % n_ct * CT;
  const int t0 = chunk * TT;
  const int nt = min(TT, Tn - t0);
  const long long base = ((long long)b * Tn + t0) * C + c0;

  // 1. stage a and x: rows of CT channels in 16-byte chunks
  constexpr int PER = 16 / sizeof(T);
  for (int q = tid; q < nt * (CT / PER); q += THREADS) {
    const int r = q / (CT / PER), cc = q % (CT / PER) * PER;
    const long long off = base + (long long)r * C + cc;
    if (vec) {
      const bool ok = c0 + cc < C;
      cp_async16(sa + r * CT + cc, ok ? a + off : a, ok);
      cp_async16(sx + r * CT + cc, ok ? x + off : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const bool ok = c0 + cc + e < C;
        sa[r * CT + cc + e] = ok ? a[off + e] : narrow<T>(0.f);
        sx[r * CT + cc + e] = ok ? x[off + e] : narrow<T>(0.f);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. the chunk's aggregate for this thread's channel
  const int c = c0 + tid;
  const bool live = c < C;
  float A = 1.f, X = 0.f;
  for (int t = 0; t < nt; ++t) {
    const float at = widen(sa[t * CT + tid]);
    X = fmaf(at, X, widen(sx[t * CT + tid]));
    A *= at;
  }
  const long long slot = ((long long)b * n_chunks + chunk) * C + c;
  int* flag = ctl + 1 + tile;
  float carry = 0.f;
  if (chunk > 0) {
    if (live) {
      agg_a[slot] = A;
      agg_x[slot] = X;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) store_release(flag, AGG);

    // 3. look back: (A_s, X_s) composes chunks j + 1 .. chunk - 1
    float As = 1.f, Xs = 0.f;
    for (int j = chunk - 1;; --j) {
      if (tid == 0) {
        const int* fj = flag - (chunk - j) * per_chunk;
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
  // 4. the inclusive carry at the chunk's end (chunk 0's is X itself)
  if (live) incl[slot] = chunk > 0 ? fmaf(A, carry, X) : X;
  __threadfence();
  __syncthreads();
  if (tid == 0) store_release(flag, INCL);

  // 5. rescan from the carry
  if (!live) return;
  float hc = carry;
  for (int t = 0; t < nt; ++t) {
    hc = fmaf(widen(sa[t * CT + tid]), hc, widen(sx[t * CT + tid]));
    h[base + (long long)t * C + tid] = narrow<T>(hc);
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
int launch(const void* a, const void* x, void* h, int B, int Tn, int C,
           void* scratch, long long scratch_size, void* stream) {
  if (B < 0 || Tn < 0 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * Tn * C == 0) return 0;
  const int n_ct = (C + CT - 1) / CT, n_chunks = (Tn + TT - 1) / TT;
  const long long tiles = (long long)B * n_ct * n_chunks;
  if (tiles >= 0x7fffffffLL || scratch_size < scratch_bytes(B, Tn, C))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * sizeof(T) * TT * CT;
  cudaError_t err = cudaFuncSetAttribute(
      lru_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  lru_scan_kernel<T><<<static_cast<unsigned>(tiles), THREADS, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(h),
      B, Tn, C, n_ct, n_chunks, vec, ctl, agg_a, agg_a + per,
      agg_a + 2 * per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: device memory of scratch_size bytes, at least scratch_bytes(B,
// T, C) (kernels/lru_scan.py::scratch_bytes computes the same; a smaller
// one is refused)
extern "C" int repro_lru_scan_f32(const void* a, const void* x, void* h,
                                  int B, int T, int C, void* scratch,
                                  long long scratch_size, void* stream) {
  return launch<float>(a, x, h, B, T, C, scratch, scratch_size, stream);
}

extern "C" int repro_lru_scan_bf16(const void* a, const void* x, void* h,
                                   int B, int T, int C, void* scratch,
                                   long long scratch_size, void* stream) {
  return launch<__nv_bfloat16>(a, x, h, B, T, C, scratch, scratch_size,
                               stream);
}
