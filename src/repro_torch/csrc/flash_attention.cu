// Causal / sliding-window flash attention for Hopper (sm_90a), GQA-native:
//   O[b, h] = softmax(scale * Q[b, h] K[b, h / group]^T + mask) V[b, h / group]
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas, the online-softmax attention of every attention
// block's prefill (repro_torch/models/attention.py::flash_attention).  Same
// function: scores scale * q.k in fp32 (q pre-scaled, as the reference
// does), masked to -1e30 (the reference's NEG, so a fully masked block adds
// exp(-1e30 - m) = 0 once a row has seen a visible key) where kpos >= Tkv,
// kpos > qpos (causal) or qpos - kpos >= window, with qpos = q_offset + row;
// running fp32 row max m, row sum l and output accumulator o across kv
// tiles; output o / max(l, 1e-30) rounded once to q's dtype.  GQA reads kv
// head h / group in place (no repeat of K or V in device memory).
//
// On the TPU the kv axis was a fori_loop inside one grid step, with o/m/l
// as its carry.  Here one CTA owns one (b, h, 64-row q tile) for its whole
// life and walks the kv tiles in a loop: the q tile (pre-scaled, widened to
// fp32) stays in shared memory, each kv tile's K (transposed) and V are
// staged in shared memory, and m, l and the o accumulator live in
// registers.  256 threads as 16 x 16: thread (ty, tx) owns q rows
// ty*4..ty*4+3 of both the score tile and the output tile, so the softmax
// rescale is thread-local; a row's max and sum are reduced over the 16
// lanes of its half-warp with shuffles.  The causal limit stops the loop at
// the kv tile holding the tile's last q position, and a window skips the
// leading tiles wholly before it (exp(-1e30 - m) = 0 exactly, so a skipped
// tile would have added nothing).  Heavy (late) q tiles are scheduled
// first.
//
// What bounds it: at the main path's shape (8 x 16 heads x 2048 tokens,
// hd 128, causal, f32) the work is ~1.4e11 FLOP (attn_flops) against
// ~0.13 GB of q, k, v and o, so the card's fp32 FMA rate is the bound.
// Arithmetic is IEEE fp32 FMA (fmaf) and expf (no fast math, no TF32);
// bf16 operands are widened to fp32 as they are staged.
//
// What the simple design gives up: no tensor cores (wgmma / mma.sync), no
// TMA or cp.async double buffering (a kv tile's loads do not overlap the
// previous tile's math), three barriers per kv tile, one CTA per 64 q rows
// (hd 256 keeps 140 KB of shared memory, one CTA per SM).  Tile sizes:
// 64 q rows; 64 kv rows for hd <= 64, 32 for hd 128 and 256 (so hd 128
// fits three CTAs per SM).
//
// Operands are (B, H, T, hd) views with element strides for b, h and t and
// a unit stride along hd, so the model's (B, T, H, hd) tensors run without
// a transpose copy; every row start is aligned to 4 elements (the wrapper
// checks).  Ragged Tq / Tkv are masked here (zero-filled loads, guarded
// stores).  Plain C entry points (no PyTorch headers) keep the build to one
// nvcc call; each returns the launch's CUDA error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int THREADS = 256;
constexpr float NEG = -1e30f;

template <int HD>
struct Tile {
  static constexpr int BKV = HD >= 128 ? 32 : 64;
  static constexpr int CS = BKV / 16;              // score cols per thread
  static constexpr int CO = HD / 16;               // output cols per thread
  static constexpr int VW = CO < 4 ? CO : 4;       // vector width along hd
  static constexpr int NG = CO / VW;               // vector groups along hd
  static constexpr int PS = BKV + 4;               // P row stride (floats)
  static constexpr int SMEM_FLOATS =
      HD * BQ + HD * BKV + BKV * HD + BQ * PS;     // Qt, Kt, Vs, Ps
};

struct Params {
  int H, Tq, Tkv, group, causal, window, q_offset;
  float scale;
  long long qs[3], ks[3], vs[3], os[3];            // strides of b, h, t
};

__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

template <int W>
__device__ __forceinline__ void lds(const float* p, float* x) {
  if constexpr (W == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else if constexpr (W == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x; x[1] = u.y;
  } else {
    x[0] = p[0];
  }
}

template <int W>
__device__ __forceinline__ void sts(float* p, const float* x) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
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

// max / sum over the 16 lanes that share a q row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ Q, const T* __restrict__ K,
              const T* __restrict__ V, T* __restrict__ O, const Params p) {
  using Tl = Tile<HD>;
  constexpr int BKV = Tl::BKV, CS = Tl::CS, CO = Tl::CO, VW = Tl::VW,
                NG = Tl::NG, PS = Tl::PS;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // [HD][BQ]  q tile, scaled, transposed
  float* Kt = Qt + HD * BQ;      // [HD][BKV] k tile, transposed
  float* Vs = Kt + HD * BKV;     // [BKV][HD] v tile
  float* Ps = Vs + BKV * HD;     // [BQ][PS]  probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / p.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const T* q = Q + b * p.qs[0] + h * p.qs[1];
  const T* k = K + b * p.ks[0] + kvh * p.ks[1];
  const T* v = V + b * p.vs[0] + kvh * p.vs[1];
  T* o = O + b * p.os[0] + h * p.os[1];

  // q tile: consecutive threads take consecutive rows (conflict-free
  // transposed stores)
  for (int i = tid; i < BQ * HD / 4; i += THREADS) {
    const int r = i % BQ, d0 = (i / BQ) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < p.Tq) load4(q + (long long)(q0 + r) * p.qs[2] + d0, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) Qt[(d0 + j) * BQ + r] = x[j] * p.scale;
  }

  // kv tiles [lo, hi): the causal limit and the window's leading edge
  const int n_kv = (p.Tkv + BKV - 1) / BKV;
  int lo = 0, hi = n_kv;
  if (p.causal) {
    const long long last =
        (long long)p.q_offset + min(q0 + BQ, p.Tq) - 1;
    hi = last < 0 ? 0 : (int)min((long long)n_kv, last / BKV + 1);
  }
  if (p.window > 0) {
    const long long first = (long long)p.q_offset + q0 - p.window + 1;
    lo = first <= 0 ? 0 : (int)min((long long)n_kv, first / BKV);
  }

  float m[4], l[4], acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile's reads are done (and Qt written)
    for (int i = tid; i < BKV * HD / 4; i += THREADS) {
      const int r = i % BKV, d0 = (i / BKV) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < p.Tkv) load4(k + (long long)(k0 + r) * p.ks[2] + d0, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) Kt[(d0 + j) * BKV + r] = x[j];
    }
    for (int i = tid; i < BKV * HD / 4; i += THREADS) {
      const int r = i / (HD / 4), d0 = (i % (HD / 4)) * 4;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < p.Tkv) load4(v + (long long)(k0 + r) * p.vs[2] + d0, x);
      sts<4>(&Vs[r * HD + d0], x);
    }
    __syncthreads();  // K and V tiles visible

    // scores: rows ty*4 + i, cols tx*CS + j
    float s[4][CS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[CS];
      lds<4>(&Qt[d * BQ + ty * 4], qa);
      lds<CS>(&Kt[d * BKV + tx * CS], kb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

    // mask + online softmax (fp32 m, l; o rescaled by exp(m_old - m_new))
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = (long long)p.q_offset + q0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int kpos = k0 + tx * CS + j;
        bool ok = kpos < p.Tkv;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        s[i][j] = ok ? s[i][j] : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= alpha;
      sts<CS>(&Ps[(ty * 4 + i) * PS + tx * CS], s[i]);
    }
    __syncthreads();  // P tile visible

    // o += P V: rows ty*4 + i, cols g*16*VW + tx*VW + j
#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lds<4>(&Ps[(ty * 4 + i) * PS + c], pr[i]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[CO];
#pragma unroll
        for (int g = 0; g < NG; ++g)
          lds<VW>(&Vs[(c + cc) * HD + g * 16 * VW + tx * VW], vv + g * VW);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int n = 0; n < CO; ++n)
            acc[i][n] = fmaf(pr[i][cc], vv[n], acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = o + (long long)r * p.os[2];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < VW; ++j)
        row[g * 16 * VW + tx * VW + j] = narrow<T>(acc[i][g * VW + j] / den);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Tile<HD>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Tq + BQ - 1) / BQ, B * p.H);
  flash_fwd<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

// dims: B, H, Tq, Tkv, hd, group, causal, window (0 = none), q_offset, then
// the b, h, t element strides of q, k, v and o (12 values).
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* dims, float scale, void* stream) {
  Params p;
  const int B = (int)dims[0];
  p.H = (int)dims[1];
  p.Tq = (int)dims[2];
  p.Tkv = (int)dims[3];
  const int hd = (int)dims[4];
  p.group = (int)dims[5];
  p.causal = (int)dims[6];
  p.window = (int)dims[7];
  p.q_offset = (int)dims[8];
  p.scale = scale;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = dims[9 + i];
    p.ks[i] = dims[12 + i];
    p.vs[i] = dims[15 + i];
    p.os[i] = dims[18 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, o, B, p, s);
    case 32: return launch_hd<T, 32>(q, k, v, o, B, p, s);
    case 64: return launch_hd<T, 64>(q, k, v, o, B, p, s);
    case 128: return launch_hd<T, 128>(q, k, v, o, B, p, s);
    case 256: return launch_hd<T, 256>(q, k, v, o, B, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_flash_attention_f32(const void* q, const void* k,
                                         const void* v, void* o,
                                         const long long* dims, float scale,
                                         void* stream) {
  return launch<float>(q, k, v, o, dims, scale, stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o,
                                          const long long* dims, float scale,
                                          void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dims, scale, stream);
}
