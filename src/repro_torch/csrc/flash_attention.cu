// Causal / sliding-window flash attention on Hopper's tensor cores (sm_90a),
// GQA-native:
//   O[b, h] = softmax(scale * Q[b, h] K[b, h / group]^T + mask) V[b, h / group]
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas, the online-softmax attention of every attention
// block's prefill (repro_torch/models/attention.py::flash_attention).  Same
// function: scores scale * q.k in fp32 (f32: q pre-scaled, as the
// reference does; bf16: the fp32 product of the unscaled q, scaled after,
// since a scaled bf16 q rounded to TF32 would carry 2^-11 of every score),
// masked to -1e30 (the reference's NEG, so a fully masked block adds
// exp(-1e30 - m) = 0 once a row has seen a visible key) where kpos >= Tkv,
// kpos > qpos (causal) or qpos - kpos >= window, with qpos = q_offset + row;
// running fp32 row max m, row sum l and output accumulator o across kv
// tiles; output o / max(l, 1e-30) rounded once to q's dtype.  GQA reads kv
// head h / group in place (no repeat of K or V in device memory).
//
// On the TPU the kv axis was a fori_loop inside one grid step, with o/m/l
// as its carry.  Here one CTA owns one (b, h, 64-row q tile) for its whole
// life and walks the kv tiles in a loop; each warp owns 16 q rows (at hd
// 256 a pair of warps does, each taking half of hd: 8 warps, half the
// registers).  The q tile (pre-scaled for f32) stays in shared memory; K and V
// tiles stream through a 2-stage cp.async ring, the copy of tile i + 1
// overlapping the math of tile i, with one barrier per tile.  S = Q K^T
// and O += P V run as 3xTF32 m16n8k8 tensor-core products (tf32x3.cuh),
// fragments split into big / small in registers as they are read; a warp
// pair adds its two halves of S through shared memory.  The online softmax
// (m, l, the rescale of O) stays in fp32 registers in the accumulator
// layout; a row's max and sum reduce over the 4 lanes of its quad with
// shuffles.  The score accumulator is P's A fragment as it stands (keys
// 2t, 2t + 1 in the k slots), so P never touches shared memory.  Each
// tile's P V is summed from zero and folded into O with one fma (o = alpha
// o + P V), so the tensor cores, which truncate as they accumulate, never
// sum more than one tile.  Masks are applied only on tiles that cross Tkv,
// the causal limit or the window edge.  The causal limit stops the loop at
// the kv tile holding the tile's last q position, and a window skips the
// leading tiles wholly before it (exp(-1e30 - m) = 0 exactly, so a skipped
// tile would have added nothing).  Heavy (late) q tiles are scheduled
// first.
//
// What bounds it: at the main path's shapes (qwen3: 8 x 16 heads x 2048
// tokens, hd 128, causal; recurrentgemma: 4 x 16 heads x 3071, hd 256,
// window 2048; f32) the work is 1.4e11 / 2.7e11 FLOP (attn_flops) against
// 0.40 / 0.43 GB of q, k, v and o, so arithmetic bounds it: 3 x FLOP at the
// card's 495 TFLOP/s TF32 rate (0.83 / 1.66 ms), against FLOP at 67 TFLOP/s
// for the fp32 FMA loop (2.05 / 4.10 ms).  Exponentials are expf (no fast
// math).  bf16 operands are widened to fp32 as they are staged and take
// the one big.big product.
//
// Sizes: 64 kv rows per tile for hd <= 64, 32 for hd 128 and 256; row
// strides hd + 8 (Q, K) and hd + 4 (V) floats keep the fragment reads free
// of bank conflicts.  Shared memory: 101 KB at hd 128 (4 warps, two CTAs
// per SM), 213 KB at hd 256 (8 warps, one CTA).
//
// Non-finite operands follow the rule of tf32x3.cuh, per q tile: a CTA
// whose tile holds a non-finite output recomputes it with an exact loop
// (exact_tile: plain attention's fp32 arithmetic over every key, the mask
// as -1e30) and counts that in *recomputes.  Plain attention also spreads
// a non-finite V element to that column of every row through 0 * inf (a
// masked key's weight is 0, not absent), including rows whose tiles the
// causal limit or the window skip here; so a pre-pass (v_nonfinite) reads
// V once and, if it finds one, every tile takes the exact loop.  The
// pre-pass costs one read of V; the check, one isfinite per output and
// one barrier per tile.
//
// For training the forward also writes each row's log-sum-exp of the
// scaled scores, lse = m + log(l) in fp32 ((B, H, Tq), contiguous), which
// the backward (flash_attention_bwd.cu) recomputes P from; with a null lse
// pointer nothing else changes, and the output is the same bits either way.
//
// What it still gives up: wgmma and TMA with a producer warp (warp
// specialisation), K / V split once per CTA instead of once per warp, and
// a 128-row q tile.
//
// Operands are (B, H, T, hd) views with element strides for b, h and t and
// a unit stride along hd, so the model's (B, T, H, hd) tensors run without
// a transpose copy; every row start is aligned to 4 elements (the wrapper
// checks).  Ragged Tq / Tkv are masked here (zero-filled loads, guarded
// stores).  Plain C entry points (no PyTorch headers) keep the build to one
// nvcc call; each returns the launch's CUDA error code.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int BQ = 64;
constexpr float NEG = -1e30f;

template <int HD>
struct Tile {
  static constexpr int BKV = HD >= 128 ? 32 : 64;
  // warps along hd: at hd 256 a pair of warps shares 16 q rows, each
  // taking half of hd (half of o and of the q.k sums)
  static constexpr int WN = HD >= 256 ? 2 : 1;
  static constexpr int THREADS = 128 * WN;
  static constexpr int SQK = HD + 8;  // Q, K row stride (floats): float2
                                      // fragment reads conflict-free
  static constexpr int SV = HD + 4;   // V row stride: column reads
                                      // conflict-free
  static constexpr int STAGE_FLOATS = BKV * (SQK + SV);  // one K + V tile
  // partial scores swapped between the warps of a pair (WN = 2)
  static constexpr int SX_FLOATS = WN > 1 ? 4 * WN * BKV * 16 : 0;
  static constexpr int SMEM_FLOATS =
      BQ * SQK + 2 * STAGE_FLOATS + SX_FLOATS;
  static constexpr int MIN_BLOCKS = WN > 1 ? 1 : 2;
};

struct Params {
  int H, Tq, Tkv, group, causal, window, q_offset;
  float scale;
  long long qs[3], ks[3], vs[3], os[3];            // strides of b, h, t
  const int* v_bad;  // set by v_nonfinite: V holds a non-finite element
  int* recomputes;   // tiles recomputed under the non-finite rule
  float* lse;        // (B, H, Tq) row log-sum-exp, or null
};

// *flag = 1 if an element of V is not finite.  Grid (x, B * KV); hd is
// 4 << hd4_log2 elements; 256 threads, four independent 4-element loads
// each per step.
template <typename T>
__global__ void __launch_bounds__(256)
    v_nonfinite(const T* __restrict__ V, const Params p, int KV,
                int hd4_log2, int* __restrict__ flag) {
  const T* v = V + (blockIdx.y / KV) * p.vs[0] + (blockIdx.y % KV) * p.vs[1];
  const int n = p.Tkv << hd4_log2, mask = (1 << hd4_log2) - 1;
  bool bad = false;
  for (int i0 = blockIdx.x * 1024 + threadIdx.x; i0 < n;
       i0 += gridDim.x * 1024) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 256 * u;
      x[u] = i < n ? read4(v + (long long)(i >> hd4_log2) * p.vs[2] +
                           ((i & mask) << 2))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      bad |= !(isfinite(x[u].x) && isfinite(x[u].y) && isfinite(x[u].z) &&
               isfinite(x[u].w));
  }
  if (bad) *flag = 1;
}

// The non-finite rule's recompute of one q tile: flash_attention_plain's
// arithmetic in fp32, a warp per row and hd across its lanes, over every
// key (masked ones as -1e30).  As there, a NaN score or scores all -inf
// make the row NaN, and a weight of 0 times an infinite V element is NaN.
template <typename T, int HD, int THREADS>
__device__ void exact_tile(const T* q, const T* k, const T* v, T* o,
                           float* lse, const Params& p, int q0, int warp,
                           int lane) {
  constexpr int DL = (HD + 31) / 32;  // hd columns per lane
  for (int r = warp; r < BQ && q0 + r < p.Tq; r += THREADS / 32) {
    const int row = q0 + r;
    const long long qpos = (long long)p.q_offset + row;
    float qv[DL], ov[DL];
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      qv[i] = d < HD ? widen(q[(long long)row * p.qs[2] + d]) * p.scale : 0.f;
      ov[i] = 0.f;
    }
    float m = -INFINITY, l = 0.f;
    bool nan = false;
    for (int j = 0; j < p.Tkv; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        if (lane + 32 * i < HD)
          s = fmaf(qv[i], widen(k[(long long)j * p.ks[2] + lane + 32 * i]), s);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      bool ok = !p.causal || j <= qpos;
      if (p.window > 0) ok = ok && qpos - j < p.window;
      if (!ok) s = NEG;
      nan = nan || isnan(s);
      const float m_new = fmaxf(m, s);
      float alpha = 1.f, pj = 0.f;  // until a score above -inf is seen
      if (m_new != -INFINITY) {
        alpha = expf(m - m_new);
        pj = expf(s - m_new);
      }
      l = l * alpha + pj;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        if (lane + 32 * i < HD)
          ov[i] = ov[i] * alpha +
                  pj * widen(v[(long long)j * p.vs[2] + lane + 32 * i]);
      m = m_new;
    }
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DL; ++i)
      if (lane + 32 * i < HD)
        o[(long long)row * p.os[2] + lane + 32 * i] =
            narrow<T>(nan || m == -INFINITY ? NAN : ov[i] / den);
    if (lse != nullptr && lane == 0) lse[row] = m + logf(l);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Tile<HD>::THREADS, Tile<HD>::MIN_BLOCKS)
    flash_fwd(const T* __restrict__ Q, const T* __restrict__ K,
              const T* __restrict__ V, T* __restrict__ O, const Params p) {
  using Tl = Tile<HD>;
  constexpr int BKV = Tl::BKV, SQK = Tl::SQK, SV = Tl::SV, WN = Tl::WN;
  constexpr int THREADS = Tl::THREADS;
  constexpr int HDW = HD / WN;  // hd columns per warp
  constexpr int NS = BKV / 8;   // score n-tiles (keys) per warp
  constexpr int NO = HDW / 8;   // output n-tiles (hd) per warp
  constexpr int NG = NO < 4 ? NO : 4;  // output n-tiles per P.V pass
  constexpr bool X3 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [BQ][SQK] q tile, scaled
  float* KV = Qs + BQ * SQK;     // 2 stages of K [BKV][SQK] then V [BKV][SV]
  float* Sx = KV + 2 * Tl::STAGE_FLOATS;  // [warp][NS * 4][32] (WN = 2)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3;           // the warp's 16 q rows
  const int d0w = (warp >> 2) * HDW; // ... and its hd columns
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kvh = h / p.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const T* q = Q + b * p.qs[0] + h * p.qs[1];
  const T* k = K + b * p.ks[0] + kvh * p.ks[1];
  const T* v = V + b * p.vs[0] + kvh * p.vs[1];
  T* o_ptr = O + b * p.os[0] + h * p.os[1];
  float* lse = p.lse == nullptr ? nullptr
                                : p.lse + ((long long)b * p.H + h) * p.Tq;

  // kv tile `tile` into ring slot s: rows of 4-element chunks, consecutive
  // threads along a row (coalesced); rows past Tkv zero-filled
  auto load_kv = [&](int tile, int s) {
    float* Ks = KV + s * Tl::STAGE_FLOATS;
    float* Vs = Ks + BKV * SQK;
    const int k0 = tile * BKV;
    for (int i = tid; i < BKV * HD / 4; i += THREADS) {
      const int r = i / (HD / 4), d0 = (i % (HD / 4)) * 4;
      const bool ok = k0 + r < p.Tkv;
      const long long row = ok ? k0 + r : 0;
      load4(Ks + r * SQK + d0, k + row * p.ks[2] + d0, ok);
      load4(Vs + r * SV + d0, v + row * p.vs[2] + d0, ok);
    }
  };

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

  for (int i = tid; i < BQ * HD / 4; i += THREADS) {
    const int r = i / (HD / 4), d0 = (i % (HD / 4)) * 4;
    const bool ok = q0 + r < p.Tq;
    load4(Qs + r * SQK + d0, q + (ok ? q0 + r : 0) * p.qs[2] + d0, ok);
  }
  if (lo < hi) load_kv(lo, 0);
  cp_async_commit();
  cp_async_wait<0>();
  // f32: pre-scale this thread's own q chunks (its copies have landed);
  // the loop's first barrier publishes them.  bf16 keeps q as loaded
  // (exact in TF32) and scales the fp32 scores instead
  if constexpr (X3) {
    for (int i = tid; i < BQ * HD / 4; i += THREADS) {
      float4* x = reinterpret_cast<float4*>(Qs + (i / (HD / 4)) * SQK
                                            + (i % (HD / 4)) * 4);
      float4 y = *x;
      y.x *= p.scale; y.y *= p.scale; y.z *= p.scale; y.w *= p.scale;
      *x = y;
    }
  }

  // this thread's rows: g and g + 8 of the warp's 16
  const long long qpos0 = (long long)p.q_offset + q0 + rg * 16 + g;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = lo; it < hi; ++it) {
    const int s = (it - lo) & 1;
    cp_async_wait<0>();  // tile `it` has landed (this thread's part)
    __syncthreads();     // ... everyone's, and slot s ^ 1 is free
    if (it + 1 < hi) load_kv(it + 1, s ^ 1);
    cp_async_commit();
    const float* Ks = KV + s * Tl::STAGE_FLOATS;
    const float* Vs = Ks + BKV * SQK;
    const int k0 = it * BKV;

    // S = (scaled Q) K^T over the warp's hd columns (bf16: Q K^T, scaled
    // below): 16 rows x BKV keys, from zero each tile
    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kq = 0; kq < HDW; kq += 8) {
      const int kk = d0w + kq;
      const float* qp = Qs + (rg * 16 + g) * SQK + kk + 2 * t;
      const float2 lo2 = *reinterpret_cast<const float2*>(qp);
      const float2 hi2 = *reinterpret_cast<const float2*>(qp + 8 * SQK);
      uint32_t ab[4], as[4];
      split_exact<X3>(lo2.x, ab[0], as[0]);
      split_exact<X3>(hi2.x, ab[1], as[1]);
      split_exact<X3>(lo2.y, ab[2], as[2]);
      split_exact<X3>(hi2.y, ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float2 kv2 = *reinterpret_cast<const float2*>(
            Ks + (8 * j + g) * SQK + kk + 2 * t);
        uint32_t bb[2], bs[2];
        split_exact<X3>(kv2.x, bb[0], bs[0]);
        split_exact<X3>(kv2.y, bb[1], bs[1]);
        mma3<X3>(sc[j], ab, as, bb, bs);
      }
    }
    if constexpr (WN > 1) {
      // add the pair's other half: both warps then hold the same scores
      // (the pair's reads finish before the next tile's barrier, so one
      // buffer serves every tile)
      float* mine = Sx + warp * NS * 4 * 32 + lane;
      const float* other = Sx + (warp ^ 4) * NS * 4 * 32 + lane;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = sc[j][e];
      asm volatile("bar.sync %0, 64;" ::"r"(1 + rg) : "memory");
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += other[(4 * j + e) * 32];
    }
    if constexpr (!X3) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= p.scale;
    }

    // masks, only on tiles that cross Tkv, the causal limit or the window
    // (element e of n-tile j: row g + 8 (e >> 1), key k0 + 8 j + 2 t + (e & 1))
    const bool edge =
        k0 + BKV > p.Tkv ||
        (p.causal && (long long)k0 + BKV - 1 > (long long)p.q_offset + q0) ||
        (p.window > 0 &&
         (long long)p.q_offset + q0 + BQ - 1 - k0 >= p.window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long qpos = qpos0 + 8 * (e >> 1);
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          bool ok = kpos < p.Tkv;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && qpos - kpos < p.window;
          if (!ok) sc[j][e] = NEG;
        }
    }

    // online softmax (fp32 m, l; o rescaled by exp(m_old - m_new)); a row's
    // max and sum reduce over the 4 lanes of its quad
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        sc[j][2 * r] = expf(sc[j][2 * r] - m_new);
        sc[j][2 * r + 1] = expf(sc[j][2 * r + 1] - m_new);
        rs += sc[j][2 * r] + sc[j][2 * r + 1];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * alpha[r] + rs;
      m[r] = m_new;
    }

    // o = alpha o + P V over the warp's hd columns: the score accumulator
    // is P's A fragment (keys 2t, 2t + 1 in k slots k0, k1), split in
    // registers; each pass sums its NG n-tiles from zero over the tile and
    // folds them into o with one fma
    uint32_t pb[NS][4], ps[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      split<X3>(sc[j][0], pb[j][0], ps[j][0]);
      split<X3>(sc[j][2], pb[j][1], ps[j][1]);
      split<X3>(sc[j][1], pb[j][2], ps[j][2]);
      split<X3>(sc[j][3], pb[j][3], ps[j][3]);
    }
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += NG) {
      float d[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float* vp = Vs + (8 * j + 2 * t) * SV + d0w + 8 * n0 + g;
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          uint32_t bb[2], bs[2];
          split<X3>(vp[8 * n], bb[0], bs[0]);
          split<X3>(vp[8 * n + SV], bb[1], bs[1]);
          mma3<X3>(d[n], pb[j], ps[j], bb, bs);
        }
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n0 + n][e] = fmaf(o[n0 + n][e], alpha[e >> 1], d[n][e]);
    }
  }

  // the non-finite rule: a non-finite output in the tile, or in V, sends
  // the whole tile to the exact loop
  // (o / max(l, 1e-30) is finite where o and l are: l >= 1 once a row
  // has seen a key, and o = 0 before)
  bool bad = *p.v_bad != 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q0 + rg * 16 + g + 8 * r >= p.Tq) continue;
    bad |= !isfinite(l[r]);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      bad |= !(isfinite(o[n][2 * r]) && isfinite(o[n][2 * r + 1]));
  }
  if (__syncthreads_or(bad)) {
    if (tid == 0) atomicAdd(p.recomputes, 1);
    exact_tile<T, HD, THREADS>(q, k, v, o_ptr, lse, p, q0, warp, lane);
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rg * 16 + g + 8 * r;
    if (row >= p.Tq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* op = o_ptr + (long long)row * p.os[2] + d0w + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(op + 8 * n, o[n][2 * r] / den, o[n][2 * r + 1] / den);
    // a quad's 4 lanes hold the same m and l (both warps of a pair too)
    if (lse != nullptr && t == 0 && warp < 4) lse[row] = m[r] + logf(l[r]);
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
  flash_fwd<T, HD><<<grid, Tile<HD>::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

// dims: B, H, Tq, Tkv, hd, group, causal, window (0 = none), q_offset, then
// the b, h, t element strides of q, k, v and o (12 values).  flag: one
// device int of scratch (the pre-pass's); recomputes: the device counter;
// lse: (B, H, Tq) fp32 for the row log-sum-exp, or null.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* dims, float scale, void* flag, void* recomputes,
           void* lse, void* stream) {
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
  p.v_bad = static_cast<const int*>(flag);
  p.recomputes = static_cast<int*>(recomputes);
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hd4_log2 = __builtin_ctz(hd / 4);
  const int KV = p.H / p.group;
  const long long chunks = ((long long)p.Tkv * (hd / 4) + 1023) / 1024;
  const int gx = chunks < 1024 ? (int)chunks : 1024;
  v_nonfinite<T><<<dim3(gx, B * KV), 256, 0, s>>>(
      static_cast<const T*>(v), p, KV, hd4_log2, static_cast<int*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
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
                                         void* flag, void* recomputes,
                                         void* lse, void* stream) {
  return launch<float>(q, k, v, o, dims, scale, flag, recomputes, lse,
                       stream);
}

extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o,
                                          const long long* dims, float scale,
                                          void* flag, void* recomputes,
                                          void* lse, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dims, scale, flag, recomputes,
                               lse, stream);
}
