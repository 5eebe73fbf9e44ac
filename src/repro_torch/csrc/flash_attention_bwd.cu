// The gradient of the causal / sliding-window GQA flash attention of
// flash_attention.cu, for training (sm_90a):
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
//   dS = P o (dO V^T - D),  D = rowsum(dO o O),  P = exp(S - lse),
// with S = scale Q K^T masked as the forward masks it (kpos >= Tkv, causal,
// window, q_offset; kv head h / group), and lse the forward's row
// log-sum-exp.
//
// The TPU kernel it is the gradient of, src/repro/kernels/flash_attention.py
// ::flash_attention_pallas, has no backward: the reference trains through
// jax.grad of its own attention.  This is the port's kernel of that
// gradient, held against the autograd of the plain version
// (kernels/flash_attention.py::flash_attention_plain).
//
// Three launches, deterministic, no atomics on the gradients:
//   1. prep, a warp per row: D = rowsum(dO o O) for every q row, and a flag
//      if q, k, v or dO holds a non-finite or large (|x| > 1e15) element or
//      D or a visible row's lse is not finite;
//   2. dq, one CTA per (b, h, 32-row q tile): walks the
//      key tiles its rows can see, recomputes S and P from lse and dP =
//      dO V^T in shared memory, and sums dS K into fp32 registers;
//   3. dkv, one CTA per (b, kv head, 32-key tile): walks the q heads of its
//      GQA group and, for each, the q tiles that can see its keys; holds dK
//      and dV in fp32 registers and writes them once.
// All products are fp32 FMA loops (the CUDA cores): first correct, then
// fast.  bf16 operands are widened as they are staged, the sums stay fp32,
// and the gradients are rounded once to the operands' dtype.
//
// A row with no visible key (qpos < 0 under the causal mask, or every key
// older than the window) has, in the plain version, the softmax of equal
// masked scores: weight 1 / Tkv on every key.  So its dO spreads over dV
// as dO / Tkv on every key, and its dq and its share of dk are 0 (the mask
// stops the score's gradient) — never NaN.  The dkv kernel adds that spread
// for the rows the visibility rule finds; P is 0 for them elsewhere.
//
// Non-finite values.  The plain version's autograd gives NaN and inf in
// particular places (the max's gradient over ties, 0 times inf in the
// products, the clamp of the softmax sum).  With the flag set, both
// gradient kernels take an exact path instead: a warp per q row (dq) or
// per key (dkv) redoes the plain version's forward and its autograd
// formulas literally in fp32 — the NaN-propagating row max and its tie
// count, exp(s - max), the clamped sum, the division's two gradients, the
// max's gradient spread evenly over the ties and multiplied by the tie mask,
// the mask's zero — so each gradient element lands in the plain version's
// class.  dq writes the per-row statistics that pass needs (max, ties, sum,
// clamped sum, the sum's and the max's gradients) and dkv reads them.  The
// large-value bound keeps every product and sum of the fast path below the
// fp32 range: 256 products of two values of 1e15 are below 3e32.
//
// What bounds it: at qwen3's training shape (8 x 16 heads (8 kv) x 2048,
// hd 128, causal) the backward is 2.5 times the forward's work counted
// densely, 3.4e11 FLOP (two recomputes of S and dP, one for each gradient
// kernel, are not counted), against 0.67 GB moved, so arithmetic bounds it:
// 2.1 ms at 3 x FLOP on the TF32 tensor cores (495 TFLOP/s), 5.1 ms as
// fp32 FMA at 67 TFLOP/s — the route this kernel takes.  What it gives up:
// the tensor cores (3xTF32 mma / wgmma as the forward), the P and dS
// tiles' round trip through shared memory, and computing dQ in the dkv
// pass (the second recompute), which the deterministic order costs here.
//
// Operands are (B, heads, T, hd) views with element strides for b, h and t
// and a unit stride along hd (the model's (B, T, heads, hd) tensors run
// without a copy); lse, D and the statistics are contiguous fp32.  Plain C
// entry points; each returns the launches' CUDA error code.

#include "tf32x3.cuh"

namespace {

using tf32x3::narrow;
using tf32x3::widen;

constexpr float NEG = -1e30f;
constexpr float LARGE = 1e15f;
constexpr int THREADS = 256;
constexpr int BK = 32;    // keys per tile
constexpr int NSTAT = 6;  // exact path: max, ties, sum, clamped sum, the
                          // sum's gradient, the max's gradient

struct Params {
  int B, H, KV, Tq, Tkv, group, causal, window, q_offset;
  float scale;
  // b, h, t element strides
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  const float* lse;  // (B, H, Tq)
  float* D;          // (B, H, Tq) scratch
  float* stats;      // (B, H, Tq, NSTAT) scratch (exact path)
  int* flag;         // set by prep: take the exact path
};

// the keys [lo, hi] row qpos can see (empty when lo > hi)
__device__ __forceinline__ void visible(long long qpos, const Params& p,
                                        long long& lo, long long& hi) {
  lo = 0;
  hi = p.Tkv - 1;
  if (p.causal && qpos < hi) hi = qpos;
  if (p.window > 0 && qpos - p.window + 1 > lo) lo = qpos - p.window + 1;
}

__device__ __forceinline__ bool ok_value(float x) {
  return isfinite(x) && fabsf(x) <= LARGE;
}

// 1. D and the flag: a warp per row; rows [0, B H Tq) are q / dO / O rows,
// the next B KV Tkv are k / v rows
template <typename T>
__global__ void __launch_bounds__(THREADS)
    prep(const T* __restrict__ Q, const T* __restrict__ K,
         const T* __restrict__ V, const T* __restrict__ O,
         const T* __restrict__ dO, const Params p, int HD) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const long long nq = (long long)p.B * p.H * p.Tq;
  const long long nk = (long long)p.B * p.KV * p.Tkv;
  bool bad = false;
  if (row < nq) {
    const int i = (int)(row % p.Tq);
    const int h = (int)((row / p.Tq) % p.H);
    const int b = (int)(row / ((long long)p.Tq * p.H));
    const T* q = Q + b * p.qs[0] + h * p.qs[1] + i * p.qs[2];
    const T* o = O + b * p.os[0] + h * p.os[1] + i * p.os[2];
    const T* g = dO + b * p.dos[0] + h * p.dos[1] + i * p.dos[2];
    float d = 0.f;
    for (int c = lane; c < HD; c += 32) {
      const float gv = widen(g[c]);
      d = fmaf(gv, widen(o[c]), d);
      bad |= !ok_value(widen(q[c])) || !ok_value(gv);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    long long lo, hi;
    visible((long long)p.q_offset + i, p, lo, hi);
    if (lane == 0) {
      p.D[row] = d;
      bad |= !isfinite(d) || (lo <= hi && !isfinite(p.lse[row]));
    }
  } else if (row < nq + nk) {
    const long long r = row - nq;
    const int j = (int)(r % p.Tkv);
    const int h = (int)((r / p.Tkv) % p.KV);
    const int b = (int)(r / ((long long)p.Tkv * p.KV));
    const T* k = K + b * p.ks[0] + h * p.ks[1] + j * p.ks[2];
    const T* v = V + b * p.vs[0] + h * p.vs[1] + j * p.vs[2];
    for (int c = lane; c < HD; c += 32)
      bad |= !ok_value(widen(k[c])) || !ok_value(widen(v[c]));
  }
  if (__any_sync(0xffffffffu, bad) && lane == 0) *p.flag = 1;
}

// a warp-wide dot product of hd-long rows, lane l holding columns
// l, l + 32, ...: the same order on every call (the exact path relies on
// recomputing a score bit for bit)
template <int DL>
__device__ __forceinline__ float warp_dot(const float (&a)[DL],
                                          const float (&b)[DL]) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DL; ++c) s = fmaf(a[c], b[c], s);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <typename T, int HD>
__device__ __forceinline__ void load_row(float (&x)[(HD + 31) / 32],
                                         const T* src, int lane,
                                         float mul = 1.f) {
#pragma unroll
  for (int c = 0; c < (HD + 31) / 32; ++c) {
    const int d = lane + 32 * c;
    x[c] = d < HD ? widen(src[d]) * mul : 0.f;
  }
}

// torch.amax's NaN-propagating maximum
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// the plain version's score: the q.k dot of the scaled row, or -1e30 where
// the mask hides the key
template <int DL>
__device__ __forceinline__ float exact_score(const float (&qf)[DL],
                                             const float (&kr)[DL],
                                             bool vis) {
  const float s = warp_dot(qf, kr);
  return vis ? s : NEG;
}

// 2, exact path: one q row per warp, the plain version's autograd
template <typename T, int HD>
__device__ void dq_exact(const T* q, const T* k, const T* v, const T* g,
                         T* dq, float* stats, const Params& p, int q0,
                         int rows) {
  constexpr int DL = (HD + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows && q0 + r < p.Tq; r += THREADS / 32) {
    const int i = q0 + r;
    const long long qpos = (long long)p.q_offset + i;
    long long lo, hi;
    visible(qpos, p, lo, hi);
    float qf[DL], gr[DL], kr[DL], vr[DL], ou[DL], dou[DL], dqf[DL];
    load_row<T, HD>(qf, q + (long long)i * p.qs[2], lane, p.scale);
    load_row<T, HD>(gr, g + (long long)i * p.dos[2], lane);
    float mx = -INFINITY;
    for (int j = 0; j < p.Tkv; ++j) {
      load_row<T, HD>(kr, k + (long long)j * p.ks[2], lane);
      mx = nan_max(mx, exact_score(qf, kr, j >= lo && j <= hi));
    }
    float ties = 0.f, sum = 0.f;
#pragma unroll
    for (int c = 0; c < DL; ++c) ou[c] = 0.f;
    for (int j = 0; j < p.Tkv; ++j) {
      load_row<T, HD>(kr, k + (long long)j * p.ks[2], lane);
      load_row<T, HD>(vr, v + (long long)j * p.vs[2], lane);
      const float s = exact_score(qf, kr, j >= lo && j <= hi);
      ties += s == mx ? 1.f : 0.f;
      const float e = expf(s - mx);
      sum += e;
#pragma unroll
      for (int c = 0; c < DL; ++c) ou[c] = fmaf(e, vr[c], ou[c]);
    }
    const float den = isnan(sum) ? NAN : fmaxf(sum, 1e-30f);
    float dden = 0.f;
#pragma unroll
    for (int c = 0; c < DL; ++c) {
      const bool in = lane + 32 * c < HD;  // padding lanes add nothing
      dou[c] = in ? gr[c] / den : 0.f;
      if (in) dden += -gr[c] * ((ou[c] / den) / den);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      dden += __shfl_xor_sync(0xffffffffu, dden, off);
    const float dsum = sum >= 1e-30f ? dden : 0.f;
    float dmx = 0.f;
    for (int j = 0; j < p.Tkv; ++j) {
      load_row<T, HD>(kr, k + (long long)j * p.ks[2], lane);
      load_row<T, HD>(vr, v + (long long)j * p.vs[2], lane);
      const float s = exact_score(qf, kr, j >= lo && j <= hi);
      const float de = dsum + warp_dot(dou, vr);
      dmx += -(de * expf(s - mx));
    }
#pragma unroll
    for (int c = 0; c < DL; ++c) dqf[c] = 0.f;
    for (int j = 0; j < p.Tkv; ++j) {
      load_row<T, HD>(kr, k + (long long)j * p.ks[2], lane);
      load_row<T, HD>(vr, v + (long long)j * p.vs[2], lane);
      const bool vis = j >= lo && j <= hi;
      const float s = exact_score(qf, kr, vis);
      const float de = dsum + warp_dot(dou, vr);
      const float ds = de * expf(s - mx) + (dmx / ties) * (s == mx ? 1.f : 0.f);
      const float dsp = vis ? ds : 0.f;
#pragma unroll
      for (int c = 0; c < DL; ++c) dqf[c] = fmaf(dsp, kr[c], dqf[c]);
    }
#pragma unroll
    for (int c = 0; c < DL; ++c)
      if (lane + 32 * c < HD)
        dq[(long long)i * p.dqs[2] + lane + 32 * c] =
            narrow<T>(dqf[c] * p.scale);
    if (lane == 0) {
      float* st = stats + (long long)i * NSTAT;
      st[0] = mx;
      st[1] = ties;
      st[2] = sum;
      st[3] = den;
      st[4] = dsum;
      st[5] = dmx;
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + a.b over four lanes, in order
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[0..3] += s * x
__device__ __forceinline__ void axpy4(float* acc, float s, float4 x) {
  acc[0] = fmaf(s, x.x, acc[0]);
  acc[1] = fmaf(s, x.y, acc[1]);
  acc[2] = fmaf(s, x.z, acc[2]);
  acc[3] = fmaf(s, x.w, acc[3]);
}

template <int HD>
struct Cfg {
  static constexpr int BQ = 32;      // q rows per tile
  static constexpr int SR = HD + 4;  // row stride (floats) of the staged
                                     // q / dO / k / v rows: float4-aligned,
                                     // and 8 rows of a float4 phase fall
                                     // on distinct banks
  static constexpr int SP = BK + 1;  // row stride of the P / dS tiles
};

// stage rows [r0, r0 + n) of a (T, hd) operand into smem rows of stride
// SR, widened (times mul); rows past `limit` are zero
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int r0, int n,
                                      int limit, float mul = 1.f) {
  constexpr int SR = Cfg<HD>::SR;
  for (int x = threadIdx.x; x < n * HD / 4; x += THREADS) {
    const int r = x / (HD / 4), d = (x % (HD / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit) {
      v = tf32x3::read4(src + (long long)(r0 + r) * stride + d);
      v.x *= mul;
      v.y *= mul;
      v.z *= mul;
      v.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * SR + d) = v;
  }
}

// S = (scaled Q) K^T and dP = dO V^T for a BQ x BK tile, then P and dS into
// shared memory.  Thread (ty, tx) = (t / 16, t % 16) owns rows ty + 16 a and
// keys tx + 16 b.
template <int HD>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       const float* lse_s, const float* D_s,
                                       const long long* lo_s,
                                       const long long* hi_s, int k0,
                                       float* Ps, float* dSs) {
  using C = Cfg<HD>;
  constexpr int RA = C::BQ / 16, RB = BK / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[RA][RB], dp[RA][RB];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) s[a][b] = dp[a][b] = 0.f;
  // four hd columns per step, as float4 loads (a dot product still adds
  // its terms in hd order)
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 qa[RA], ga[RA], kb[RB], vb[RB];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      qa[a] = ld4(Qs + (ty + 16 * a) * C::SR + d);
      ga[a] = ld4(dOs + (ty + 16 * a) * C::SR + d);
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      kb[b] = ld4(Ks + (tx + 16 * b) * C::SR + d);
      vb[b] = ld4(Vs + (tx + 16 * b) * C::SR + d);
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        s[a][b] = dot4(qa[a], kb[b], s[a][b]);
        dp[a][b] = dot4(ga[a], vb[b], dp[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int i = ty + 16 * a, j = tx + 16 * b;
      const long long kpos = k0 + j;
      const bool vis = kpos >= lo_s[i] && kpos <= hi_s[i];
      const float pr = vis ? expf(s[a][b] - lse_s[i]) : 0.f;
      if (Ps != nullptr) Ps[i * C::SP + j] = pr;
      dSs[i * C::SP + j] = pr * (dp[a][b] - D_s[i]);
    }
}

// per-row data of a q tile: scaled q, dO, lse, D and the visible keys
// (rows with no visible key, or past Tq, get an empty range: P = 0)
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(
    float* Qs, float* dOs, float* lse_s, float* D_s, long long* lo_s,
    long long* hi_s, const T* q, const T* g, const float* lse,
    const float* D, const Params& p, int q0) {
  constexpr int BQ = Cfg<HD>::BQ;
  stage<T, HD>(Qs, q, p.qs[2], q0, BQ, p.Tq, p.scale);
  stage<T, HD>(dOs, g, p.dos[2], q0, BQ, p.Tq);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int i = q0 + r;
    long long lo = 1, hi = 0;
    if (i < p.Tq) visible((long long)p.q_offset + i, p, lo, hi);
    lo_s[r] = lo;
    hi_s[r] = hi;
    lse_s[r] = i < p.Tq && lo <= hi ? lse[i] : 0.f;
    D_s[r] = i < p.Tq ? D[i] : 0.f;
  }
}

template <int HD>
constexpr int dq_smem_floats() {
  using C = Cfg<HD>;
  return 2 * C::BQ * C::SR + 2 * BK * C::SR + C::BQ * C::SP + 2 * C::BQ +
         4 * C::BQ;  // + lo / hi as long longs
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq(const T* __restrict__ Q, const T* __restrict__ K,
                 const T* __restrict__ V, const T* __restrict__ dO,
                 T* __restrict__ dQ, const Params p) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ;
  constexpr int TPR = THREADS / BQ;  // threads per row of dq
  constexpr int DPT = HD / TPR;      // dq columns per thread
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / p.group;
  const int q0 = blockIdx.x * BQ;
  const T* q = Q + b * p.qs[0] + h * p.qs[1];
  const T* k = K + b * p.ks[0] + kvh * p.ks[1];
  const T* v = V + b * p.vs[0] + kvh * p.vs[1];
  const T* g = dO + b * p.dos[0] + h * p.dos[1];
  T* dq = dQ + b * p.dqs[0] + h * p.dqs[1];
  const long long row0 = ((long long)b * p.H + h) * p.Tq;
  if (*p.flag) {
    dq_exact<T, HD>(q, k, v, g, dq, p.stats + row0 * NSTAT, p, q0, BQ);
    return;
  }
  float* Qs = smem;
  float* dOs = Qs + BQ * C::SR;
  float* Ks = dOs + BQ * C::SR;
  float* Vs = Ks + BK * C::SR;
  float* dSs = Vs + BK * C::SR;
  float* lse_s = dSs + BQ * C::SP;
  float* D_s = lse_s + BQ;
  long long* lo_s = reinterpret_cast<long long*>(D_s + BQ);
  long long* hi_s = lo_s + BQ;
  stage_rows<T, HD>(Qs, dOs, lse_s, D_s, lo_s, hi_s, q, g, p.lse + row0,
                    p.D + row0, p, q0);
  // the key tiles the tile's rows can see (lo and hi grow with the row)
  long long lo, hi, lo_last, hi_last;
  visible((long long)p.q_offset + q0, p, lo, hi);
  visible((long long)p.q_offset + min(q0 + BQ, p.Tq) - 1, p, lo_last,
          hi_last);
  if (lo < 0) lo = 0;
  const int t_lo = (int)(lo / BK);
  const int t_hi = hi_last < lo ? t_lo - 1 : (int)(hi_last / BK);
  const int r = threadIdx.x % BQ, c0 = (threadIdx.x / BQ) * DPT;
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;
  for (int tile = t_lo; tile <= t_hi; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the last tile's reads of Ks / dSs are done
    stage<T, HD>(Ks, k, p.ks[2], k0, BK, p.Tkv);
    stage<T, HD>(Vs, v, p.vs[2], k0, BK, p.Tkv);
    __syncthreads();
    scores<HD>(Qs, dOs, Ks, Vs, lse_s, D_s, lo_s, hi_s, k0, nullptr, dSs);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float ds = dSs[r * C::SP + j];
      if constexpr (DPT % 4 == 0) {
#pragma unroll
        for (int c = 0; c < DPT; c += 4)
          axpy4(acc + c, ds, ld4(Ks + j * C::SR + c0 + c));
      } else {
#pragma unroll
        for (int c = 0; c < DPT; ++c)
          acc[c] = fmaf(ds, Ks[j * C::SR + c0 + c], acc[c]);
      }
    }
  }
  if (q0 + r < p.Tq) {
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      dq[(long long)(q0 + r) * p.dqs[2] + c0 + c] =
          narrow<T>(acc[c] * p.scale);
  }
}

// 3, exact path: one key per warp over every q row of the group
template <typename T, int HD>
__device__ void dkv_exact(const T* Q, const T* k, const T* v, const T* dO,
                          T* dk, T* dv, const float* stats, const Params& p,
                          int b, int kvh, int k0) {
  constexpr int DL = (HD + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int jj = warp; jj < BK && k0 + jj < p.Tkv; jj += THREADS / 32) {
    const int j = k0 + jj;
    float kr[DL], vr[DL], qf[DL], gr[DL], dou[DL], dkr[DL], dvr[DL];
    load_row<T, HD>(kr, k + (long long)j * p.ks[2], lane);
    load_row<T, HD>(vr, v + (long long)j * p.vs[2], lane);
#pragma unroll
    for (int c = 0; c < DL; ++c) dkr[c] = dvr[c] = 0.f;
    for (int hg = 0; hg < p.group; ++hg) {
      const int h = kvh * p.group + hg;
      const T* q = Q + b * p.qs[0] + h * p.qs[1];
      const T* g = dO + b * p.dos[0] + h * p.dos[1];
      const float* st = stats + ((long long)b * p.H + h) * p.Tq * NSTAT;
      for (int i = 0; i < p.Tq; ++i) {
        long long lo, hi;
        visible((long long)p.q_offset + i, p, lo, hi);
        const bool vis = j >= lo && j <= hi;
        const float* si = st + (long long)i * NSTAT;
        const float mx = si[0], ties = si[1], den = si[3], dsum = si[4],
                    dmx = si[5];
        load_row<T, HD>(qf, q + (long long)i * p.qs[2], lane, p.scale);
        load_row<T, HD>(gr, g + (long long)i * p.dos[2], lane);
#pragma unroll
        for (int c = 0; c < DL; ++c)
          dou[c] = lane + 32 * c < HD ? gr[c] / den : 0.f;
        const float s = exact_score(qf, kr, vis);
        const float e = expf(s - mx);
        const float de = dsum + warp_dot(dou, vr);
        const float ds = de * e + (dmx / ties) * (s == mx ? 1.f : 0.f);
        const float dsp = vis ? ds : 0.f;
#pragma unroll
        for (int c = 0; c < DL; ++c) {
          dvr[c] = fmaf(e, dou[c], dvr[c]);
          dkr[c] = fmaf(dsp, qf[c], dkr[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < DL; ++c)
      if (lane + 32 * c < HD) {
        dk[(long long)j * p.dks[2] + lane + 32 * c] = narrow<T>(dkr[c]);
        dv[(long long)j * p.dvs[2] + lane + 32 * c] = narrow<T>(dvr[c]);
      }
  }
}

template <int HD>
constexpr int dkv_smem_floats() {
  using C = Cfg<HD>;
  return 2 * C::BQ * C::SR + 2 * BK * C::SR + 2 * C::BQ * C::SP +
         2 * C::BQ + 4 * C::BQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv(const T* __restrict__ Q, const T* __restrict__ K,
                  const T* __restrict__ V, const T* __restrict__ dO,
                  T* __restrict__ dK, T* __restrict__ dV, const Params p) {
  using C = Cfg<HD>;
  constexpr int BQ = C::BQ;
  constexpr int DPT = HD * BK / THREADS;  // dk / dv columns per thread
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y / p.KV, kvh = blockIdx.y % p.KV;
  const int k0 = blockIdx.x * BK;
  const T* k = K + b * p.ks[0] + kvh * p.ks[1];
  const T* v = V + b * p.vs[0] + kvh * p.vs[1];
  T* dk = dK + b * p.dks[0] + kvh * p.dks[1];
  T* dv = dV + b * p.dvs[0] + kvh * p.dvs[1];
  if (*p.flag) {
    dkv_exact<T, HD>(Q, k, v, dO, dk, dv, p.stats, p, b, kvh, k0);
    return;
  }
  float* Ks = smem;
  float* Vs = Ks + BK * C::SR;
  float* Qs = Vs + BK * C::SR;
  float* dOs = Qs + BQ * C::SR;
  float* Ps = dOs + BQ * C::SR;
  float* dSs = Ps + BQ * C::SP;
  float* lse_s = dSs + BQ * C::SP;
  float* D_s = lse_s + BQ;
  long long* lo_s = reinterpret_cast<long long*>(D_s + BQ);
  long long* hi_s = lo_s + BQ;
  stage<T, HD>(Ks, k, p.ks[2], k0, BK, p.Tkv);
  stage<T, HD>(Vs, v, p.vs[2], k0, BK, p.Tkv);
  const int kl = min(k0 + BK, p.Tkv) - 1;  // the tile's last key
  // q rows that can see a key of [k0, kl]: qpos >= k0 (causal) and
  // qpos - kl < window
  long long i_lo = 0, i_hi = p.Tq - 1;
  if (p.causal) i_lo = max(i_lo, (long long)k0 - p.q_offset);
  if (p.window > 0)
    i_hi = min(i_hi, (long long)kl + p.window - 1 - p.q_offset);
  const int jk = threadIdx.x % BK, c0 = (threadIdx.x / BK) * DPT;
  float ak[DPT], av[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) ak[c] = av[c] = 0.f;
  for (int hg = 0; hg < p.group; ++hg) {
    const int h = kvh * p.group + hg;
    const T* q = Q + b * p.qs[0] + h * p.qs[1];
    const T* g = dO + b * p.dos[0] + h * p.dos[1];
    const long long row0 = ((long long)b * p.H + h) * p.Tq;
    for (long long i0 = (i_lo / BQ) * BQ; i0 <= i_hi; i0 += BQ) {
      __syncthreads();  // the last tile's reads are done
      stage_rows<T, HD>(Qs, dOs, lse_s, D_s, lo_s, hi_s, q, g,
                        p.lse + row0, p.D + row0, p, (int)i0);
      __syncthreads();
      scores<HD>(Qs, dOs, Ks, Vs, lse_s, D_s, lo_s, hi_s, k0, Ps, dSs);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float pr = Ps[r * C::SP + jk], ds = dSs[r * C::SP + jk];
        if constexpr (DPT % 4 == 0) {
#pragma unroll
          for (int c = 0; c < DPT; c += 4) {
            axpy4(av + c, pr, ld4(dOs + r * C::SR + c0 + c));
            axpy4(ak + c, ds, ld4(Qs + r * C::SR + c0 + c));
          }
        } else {
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            av[c] = fmaf(pr, dOs[r * C::SR + c0 + c], av[c]);
            ak[c] = fmaf(ds, Qs[r * C::SR + c0 + c], ak[c]);
          }
        }
      }
    }
    // rows with no visible key: weight 1 / Tkv on every key in the plain
    // softmax, so dO / Tkv on every key's dv
    const float inv = 1.f / (float)p.Tkv;
    long long m_lo = 0, m_hi = -1, w_lo = p.Tq, w_hi = p.Tq - 1;
    if (p.causal) m_hi = min((long long)p.Tq, -(long long)p.q_offset) - 1;
    if (p.window > 0)
      w_lo = max((long long)0, (long long)p.Tkv + p.window - 1 - p.q_offset);
    for (int pass = 0; pass < 2; ++pass) {
      const long long a0 = pass ? max(w_lo, m_hi + 1) : m_lo;
      const long long a1 = pass ? w_hi : m_hi;
      for (long long i = a0; i <= a1; ++i) {
        const T* gi = g + i * p.dos[2];
#pragma unroll
        for (int c = 0; c < DPT; ++c)
          av[c] = fmaf(widen(gi[c0 + c]), inv, av[c]);
      }
    }
  }
  if (k0 + jk < p.Tkv) {
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk[(long long)(k0 + jk) * p.dks[2] + c0 + c] = narrow<T>(ak[c]);
      dv[(long long)(k0 + jk) * p.dvs[2] + c0 + c] = narrow<T>(av[c]);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* dO,
              void* dq, void* dk, void* dv, const Params& p,
              cudaStream_t s) {
  using C = Cfg<HD>;
  const size_t sq = sizeof(float) * dq_smem_floats<HD>();
  const size_t skv = sizeof(float) * dkv_smem_floats<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)skv);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dq first: on the exact path it writes the row statistics dkv reads
  flash_bwd_dq<T, HD><<<dim3((p.Tq + C::BQ - 1) / C::BQ, p.B * p.H),
                         THREADS, sq, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO),
      static_cast<T*>(dq), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv<T, HD><<<dim3((p.Tkv + BK - 1) / BK, p.B * p.KV), THREADS,
                          skv, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO),
      static_cast<T*>(dk), static_cast<T*>(dv), p);
  return static_cast<int>(cudaGetLastError());
}

// dims: B, H, Tq, Tkv, hd, group, causal, window (0 = none), q_offset, then
// the b, h, t element strides of q, k, v, o, dO, dq, dk and dv (24 values).
// lse: the forward's (B, H, Tq) fp32; D: (B, H, Tq) and stats:
// (B, H, Tq, 6) fp32 scratch; flag: one device int of scratch.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const void* lse, void* dq, void* dk, void* dv,
           const long long* dims, float scale, void* D, void* stats,
           void* flag, void* stream) {
  Params p;
  p.B = (int)dims[0];
  p.H = (int)dims[1];
  p.Tq = (int)dims[2];
  p.Tkv = (int)dims[3];
  const int hd = (int)dims[4];
  p.group = (int)dims[5];
  p.KV = p.H / p.group;
  p.causal = (int)dims[6];
  p.window = (int)dims[7];
  p.q_offset = (int)dims[8];
  p.scale = scale;
  long long* strides[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int a = 0; a < 8; ++a)
    for (int i = 0; i < 3; ++i) strides[a][i] = dims[9 + 3 * a + i];
  p.lse = static_cast<const float*>(lse);
  p.D = static_cast<float*>(D);
  p.stats = static_cast<float*>(stats);
  p.flag = static_cast<int*>(flag);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = (long long)p.B * p.H * p.Tq +
                         (long long)p.B * p.KV * p.Tkv;
  prep<T><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS,
            0, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), static_cast<const T*>(o),
                    static_cast<const T*>(dO), p, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, dO, dq, dk, dv, p, s);
    case 32: return launch_hd<T, 32>(q, k, v, dO, dq, dk, dv, p, s);
    case 64: return launch_hd<T, 64>(q, k, v, dO, dq, dk, dv, p, s);
    case 128: return launch_hd<T, 128>(q, k, v, dO, dq, dk, dv, p, s);
    case 256: return launch_hd<T, 256>(q, k, v, dO, dq, dk, dv, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv,
    const long long* dims, float scale, void* D, void* stats, void* flag,
    void* stream) {
  return launch<float>(q, k, v, o, dO, lse, dq, dk, dv, dims, scale, D, stats,
                       flag, stream);
}

extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv,
    const long long* dims, float scale, void* D, void* stats, void* flag,
    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dO, lse, dq, dk, dv, dims, scale,
                               D, stats, flag, stream);
}
