// Linear-recurrence scan for Hopper (sm_90a), elementwise over channels:
//   h[b, t, c] = a[b, t, c] * h[b, t - 1, c] + x[b, t, c],   h[b, -1, c] = 0
//
// Replaces the TPU kernel src/repro/kernels/lru_scan.py::lru_scan_pallas,
// the RG-LRU recurrence of every rglru block's prefill
// (repro_torch/models/rglru.py::rglru_scan, called with a = exp(log_a)).
// Same function: the carry is fp32 from 0, each step is one IEEE fmaf(a, h,
// x) (no fast math), a and x are widened to fp32 as they are loaded, and
// each h is rounded once to x's dtype when stored.
//
// On the TPU the time axis was an "arbitrary" grid dimension with the carry
// in a VMEM scratch that persisted across its steps.  Hopper's blocks run
// in no order, so nothing carries between them: here one thread owns one
// (b, c) chain for its whole life and walks t in a loop, the carry in a
// register.  Consecutive threads take consecutive c, so every load and
// store of a step is one coalesced row segment.  The loads do not depend
// on h, so the loop is software-pipelined: the next STEPS steps of a and x
// are loaded into registers before the current STEPS dependent FMAs run,
// which keeps 2 * STEPS loads of each thread in flight to hide HBM latency.
//
// What bounds it: the work is one FMA per element against 3 x 4 bytes
// (f32: a and x read once, h written once), so the card's memory rate is
// the bound (3 B T C 4 bytes / 3.35 TB/s).  The design reaches it only
// with enough chains in flight: at B = 8, C = 4096 there are 32,768
// threads (256 CTAs of 128, about 2 per SM); at B = 1, a lone prompt in an
// exact-length bucket, only 4,096 threads (32 CTAs on 132 SMs), each
// walking T dependent steps, so that shape stays far from its bound.  A
// serving run's prefill groups of B = 4 (16,384 threads, 128 CTAs, about
// one per SM) fall between the two.
//
// What the simple design gives up: parallelism along T.  The later fix is
// the chunked two-pass scan: pass 1 scans each T-chunk locally from a zero
// carry and also forms the chunk's decay product; a carry pass combines
// the chunk ends in order; pass 2 (or a fused epilogue) adds
// prod(a) * carry into each chunk.  That gives B * C * (T / chunk) threads.
//
// Operands are contiguous (B, T, C); any T and C (the ragged edge is
// masked here, so no padding is needed).  Plain C entry points (no PyTorch
// headers) keep the build to one nvcc call; each returns the launch's CUDA
// error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int STEPS = 8;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                    T* __restrict__ h, int B, int Tn, int C) {
  const long long chain = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (chain >= (long long)B * C) return;
  const long long b = chain / C, c = chain % C;
  const long long base = b * (long long)Tn * C + c;
  const T* ap = a + base;
  const T* xp = x + base;
  T* hp = h + base;

  float carry = 0.f;
  float a_cur[STEPS], x_cur[STEPS], a_nxt[STEPS], x_nxt[STEPS];
  const int full = Tn / STEPS * STEPS;  // steps in whole STEPS groups
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const bool in = u < full;
    a_cur[u] = in ? load(ap + (long long)u * C) : 0.f;
    x_cur[u] = in ? load(xp + (long long)u * C) : 0.f;
  }
  for (int t0 = 0; t0 < full; t0 += STEPS) {
    const int t1 = t0 + STEPS;
    // issue the next group's loads before this group's dependent FMAs
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const bool in = t1 + u < full;
      const long long off = (long long)(t1 + u) * C;
      a_nxt[u] = in ? load(ap + off) : 0.f;
      x_nxt[u] = in ? load(xp + off) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      carry = fmaf(a_cur[u], carry, x_cur[u]);
      store(hp + (long long)(t0 + u) * C, carry);
    }
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      a_cur[u] = a_nxt[u];
      x_cur[u] = x_nxt[u];
    }
  }
  for (int t = full; t < Tn; ++t) {  // the ragged tail, < STEPS steps
    const long long off = (long long)t * C;
    carry = fmaf(load(ap + off), carry, load(xp + off));
    store(hp + off, carry);
  }
}

template <typename T>
int launch(const void* a, const void* x, void* h, int B, int Tn, int C,
           void* stream) {
  if (B < 0 || Tn < 0 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long chains = (long long)B * C;
  if (chains == 0 || Tn == 0) return 0;
  const long long blocks = (chains + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lru_scan_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(h),
      B, Tn, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_lru_scan_f32(const void* a, const void* x, void* h,
                                  int B, int T, int C, void* stream) {
  return launch<float>(a, x, h, B, T, C, stream);
}

extern "C" int repro_lru_scan_bf16(const void* a, const void* x, void* h,
                                   int B, int T, int C, void* stream) {
  return launch<__nv_bfloat16>(a, x, h, B, T, C, stream);
}
