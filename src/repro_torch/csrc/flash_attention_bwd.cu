// The gradient of the causal / sliding-window GQA flash attention of
// flash_attention.cu, for training, on Hopper's tensor cores (sm_90a):
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO,
//   dS = P o (dP - D),  dP = dO V^T,  D = rowsum(dO o O),
//   P = exp(scale Q K^T - lse),
// with the scores masked as the forward masks them (kpos >= Tkv, causal,
// window, q_offset; kv head h / group) and lse the forward's row
// log-sum-exp.
//
// The TPU kernel it is the gradient of, src/repro/kernels/flash_attention.py
// ::flash_attention_pallas, has no backward: the reference trains through
// jax.grad of its own attention.  This is the port's kernel of that
// gradient, held against the autograd of the plain version
// (kernels/flash_attention.py::flash_attention_plain).
//
// Launches, deterministic (no atomics on dQ, dK or dV: two calls on the
// same inputs give the same bits):
//   1. prep, a warp per row: D for every q row, and flag[0] if q, k, v or dO
//      holds a non-finite or large (|x| > 1e15) element, or D or a visible
//      row's lse is not finite;
//   2. dq, one CTA per (b, h, 64-row q tile), heavy (late) tiles first: Q
//      and dO stay in shared memory, the key tiles its rows can see stream
//      through a 2-stage cp.async ring (K and V, 16 keys at hd >= 128, 32
//      below); per tile S = Q K^T and dP = dO V^T, then P and dS in
//      registers, then dQ += dS K;
//   3. dkv, one CTA per (b, kv head, 64-key tile[, share of the group's q
//      heads]), heavy (early) tiles first: K and V stay in shared memory,
//      the (q head, q tile) pairs that can see its keys stream through the
//      ring (Q, dO and their rows' lse and D, 16 q rows at hd >= 128, 32
//      below); per tile S^T = K Q^T and dP^T = V dO^T with the keys as the
//      M rows, then dV += P^T dO and dK += dS^T Q;
//   4. when the group's q heads are split (below), the sum of the dK / dV
//      partials in split order;
//   5-6. the exact path's dq and dk / dv, which return at once unless
//      flag[0] or flag[1] is set.
// All five products run as 3xTF32 m16n8k8 mma.sync products (tf32x3.cuh),
// fragments split into big / small in registers as they are read; bf16
// operands are widened as they are staged and take the one big.big
// product.  A warp owns 16 resident rows; at hd 256 a pair of warps splits
// hd and adds its two halves of S and dP through shared memory (a + b ==
// b + a, so both hold the same bits).  The score accumulator is the next
// product's A fragment as it stands: column c of an n-tile holds streamed
// row 8 j + pi(c), pi(c) = c ^ (c >> 2), and its k slots k0 = 2t, k1 =
// 2t + 1 take rows pi(2t) and pi(2t + 1) of the B operand.  So P and dS
// never touch shared memory, and with a row stride of hd + 8 floats both
// reads of a streamed row are free of bank conflicts: along the row as a
// float2 (the S / dP B operand) and down a column (the B operand of dQ,
// dK, dV).  Each tile's dQ, dK or dV product is summed from zero and added
// into the fp32 sum with one IEEE add, so the tensor cores, which truncate
// as they accumulate, never sum more than one tile.
//
// Enough CTAs at few kv heads: when B x KV x key tiles is under two waves
// of the card's CTA slots (the hybrid's one kv head), the dkv grid splits
// each group's q heads into `splits` contiguous shares (a power of 2
// capped at the group; the wrapper picks it from the card's SM count and
// the CTAs an SM holds, Fast<HD>::MIN_BLOCKS).  Each CTA then writes its fp32 dK / dV partials to a
// scratch of 2 x splits x B x KV x Tkv x hd floats (the wrapper's `part`),
// and launch 4 adds them in split order (one read of it, one write of dK
// and dV): at 4 x 3071 keys x hd 256 with 2 splits, 50 MB each way.
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
// products, the clamp of the softmax sum).  With flag[0] set, the fast
// kernels return at once and the exact path runs: a warp per q row (dq) or
// per key (dkv) redoes the plain version's forward and its autograd
// formulas literally in fp32 — the NaN-propagating row max and its tie
// count, exp(s - max), the clamped sum, the division's two gradients, the
// max's gradient spread evenly over the ties and multiplied by the tie mask,
// the mask's zero — so each gradient element lands in the plain version's
// class.  dq writes the per-row statistics that pass needs (max, ties, sum,
// clamped sum, the sum's and the max's gradients) and dkv reads them.  The
// flag does not cover everything: finite operands below 1e15 can still
// overflow a gradient (dS near 1e30 times a q element near 1e15), where
// 3xTF32's cross terms give NaN for the fp32 product's inf, and a score
// recomputed far above the forward's lse overflows P.  So, as tf32x3.cuh's
// rule does per tile, every fast CTA (and the partials' sum) checks its
// outputs; one that finds a non-finite value adds one to *recomputes and
// sets flag[1], and the exact path then recomputes every gradient.  The
// counter reads 0 wherever the fast path's gradients are finite.
//
// What bounds it: at qwen3's training shape as one node launches it (4 x 16
// heads (8 kv) x 2048, hd 128, causal) the backward is 2.5 times the
// forward's work counted densely, 1.7e11 FLOP, against 0.40 GB moved, so
// arithmetic bounds it: 1.04 ms at 3 x FLOP on the TF32 tensor cores (495
// TFLOP/s).  The kernel does 7 products per visible (q, k) pair, not 5:
// dq and dkv each recompute S and dP (computing dQ in the dkv pass instead
// would need a deterministic sum of per-key-tile dQ partials, ~1 GB written
// and read at that shape).  What it still gives up: wgmma (TF32 wgmma takes
// B only K-major, so dV = P^T dO and dK = dS^T Q would need dO and Q staged
// transposed), TMA with a producer warp, and K / V (dq) or Q / dO (dkv)
// split once per CTA instead of once per warp.
//
// Operands are (B, heads, T, hd) views with element strides for b, h and t
// and a unit stride along hd (the model's (B, T, heads, hd) tensors run
// without a copy), every row start aligned to 4 elements; lse, D, the
// statistics and the partials are contiguous fp32.  Plain C entry points;
// each returns the launches' CUDA error code.

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float NEG = -1e30f;
constexpr float LARGE = 1e15f;
constexpr int THREADS = 256;  // prep, the exact path, the partials' sum
constexpr int EX = 32;        // exact path: q rows / keys per CTA
constexpr int NSTAT = 6;      // exact path: max, ties, sum, clamped sum, the
                              // sum's gradient, the max's gradient

struct Params {
  int B, H, KV, Tq, Tkv, group, causal, window, q_offset, splits;
  float scale;
  // b, h, t element strides
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  const float* lse;  // (B, H, Tq)
  float* D;          // (B, H, Tq) scratch
  float* stats;      // (B, H, Tq, NSTAT) scratch (exact path)
  float* part;       // (2, splits, B, KV, Tkv, hd) scratch (splits > 1)
  int* flag;         // [0] set by prep, [1] by a fast CTA: take the exact
                     // path
  int* recomputes;   // fast CTAs that found a non-finite gradient
};

// the keys [lo, hi] row qpos can see (empty when lo > hi)
__device__ __forceinline__ void visible(long long qpos, const Params& p,
                                        long long& lo, long long& hi) {
  lo = 0;
  hi = p.Tkv - 1;
  if (p.causal && qpos < hi) hi = qpos;
  if (p.window > 0 && qpos - p.window + 1 > lo) lo = qpos - p.window + 1;
}

// whether row qpos (a row of q when row_ok) sees key kpos
__device__ __forceinline__ bool sees(long long qpos, long long kpos,
                                     bool row_ok, const Params& p) {
  return row_ok && kpos < p.Tkv && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

__device__ __forceinline__ bool ok_value(float x) {
  return isfinite(x) && fabsf(x) <= LARGE;
}

// 1. D and flag[0]: a warp per row; rows [0, B H Tq) are q / dO / O rows,
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
  if (__any_sync(0xffffffffu, bad) && lane == 0) p.flag[0] = 1;
}

// -- the fast path ----------------------------------------------------------

// A CTA keeps R = 64 rows of its own operands resident (16 per row-warp,
// four row-warps) and streams BS rows of the other side at a time through
// a 2-stage ring; at hd 256 a pair of warps splits hd.  Row stride ST =
// hd + 8 floats (ST = 8 mod 32: rows r with distinct r mod 4 fall on
// distinct 8-bank groups).  The dq and dk / dv passes take the same tiles.
template <int HD_>
struct Fast {
  static constexpr int HD = HD_;
  static constexpr int WN = HD >= 256 ? 2 : 1;  // warps along hd
  static constexpr int RW = 4;                  // warps along the rows
  static constexpr int THREADS = 32 * RW * WN;
  static constexpr int R = 16 * RW;             // resident rows
  static constexpr int BS = HD >= 128 ? 16 : 32;  // streamed rows a step
  static constexpr int ST = HD + 8;
  static constexpr int HDW = HD / WN;           // hd columns per warp
  static constexpr int NS = BS / 8;             // score n-tiles per warp
  static constexpr int NO = HDW / 8;            // output n-tiles per warp
  static constexpr int NG = NO < 4 ? NO : 4;    // output n-tiles a pass
  static constexpr int STAGE = 2 * BS * ST;     // two operands' rows
  // partial S and dP swapped between the warps of a pair (WN = 2)
  static constexpr int SX = WN > 1 ? RW * WN * 2 * NS * 4 * 32 : 0;
  static constexpr int ROWS = 4 * BS;  // 2 stages of lse, D (dkv)
  // resident rows, the ring, the streamed rows' lse and D, the swap
  static constexpr int SMEM_FLOATS = 2 * R * ST + 2 * STAGE + ROWS + SX;
  static constexpr int MIN_BLOCKS = WN > 1 ? 1 : 2;
};

// the streamed row (within its 8) that column c of a score n-tile holds
__device__ __forceinline__ int pi(int c) { return c ^ (c >> 2); }

// the A fragment of rows g and g + 8 at columns x[0], x[1] (k slots 2t,
// 2t + 1), split
template <bool X3, int ST>
__device__ __forceinline__ void frag_a(const float* x, uint32_t (&b)[4],
                                       uint32_t (&s)[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(x);
  const float2 hi = *reinterpret_cast<const float2*>(x + 8 * ST);
  split_exact<X3>(lo.x, b[0], s[0]);
  split_exact<X3>(hi.x, b[1], s[1]);
  split_exact<X3>(lo.y, b[2], s[2]);
  split_exact<X3>(hi.y, b[3], s[3]);
}

// the B fragment of one row at columns y[0], y[1], split
template <bool X3>
__device__ __forceinline__ void frag_b(const float* y, uint32_t (&b)[2],
                                       uint32_t (&s)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(y);
  split_exact<X3>(v.x, b[0], s[0]);
  split_exact<X3>(v.y, b[1], s[1]);
}

// a1 = X1 Y1^T and a2 = X2 Y2^T for one warp: its 16 resident rows (X, from
// the warp's first row) by the stage's BS streamed rows (Y), over hd
// columns [d0, d0 + HDW), summed from zero.  Column c of n-tile j is
// streamed row 8 j + pi(c).
template <bool X3, class F>
__device__ __forceinline__ void scores2(const float* X1, const float* Y1,
                                        const float* X2, const float* Y2,
                                        int d0, int g, int t, int pg,
                                        float (&a1)[F::NS][4],
                                        float (&a2)[F::NS][4]) {
  constexpr int ST = F::ST;
#pragma unroll
  for (int j = 0; j < F::NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a1[j][e] = a2[j][e] = 0.f;
#pragma unroll
  for (int kq = 0; kq < F::HDW; kq += 8) {
    const int kk = d0 + kq + 2 * t;
    uint32_t xb1[4], xs1[4], xb2[4], xs2[4];
    frag_a<X3, ST>(X1 + g * ST + kk, xb1, xs1);
    frag_a<X3, ST>(X2 + g * ST + kk, xb2, xs2);
#pragma unroll
    for (int j = 0; j < F::NS; ++j) {
      uint32_t yb[2], ys[2];
      frag_b<X3>(Y1 + (8 * j + pg) * ST + kk, yb, ys);
      mma3<X3>(a1[j], xb1, xs1, yb, ys);
      frag_b<X3>(Y2 + (8 * j + pg) * ST + kk, yb, ys);
      mma3<X3>(a2[j], xb2, xs2, yb, ys);
    }
  }
}

// at hd 256: add the pair's other hd half into a1 and a2, so both warps
// hold the same sums.  The reads finish before the next step's CTA barrier,
// so one buffer serves every step.
template <class F>
__device__ __forceinline__ void swap_halves(float* Sx, int warp, int lane,
                                            float (&a1)[F::NS][4],
                                            float (&a2)[F::NS][4]) {
  if constexpr (F::WN > 1) {
    constexpr int NS = F::NS, W = 2 * NS * 4 * 32;
    float* mine = Sx + warp * W + lane;
    const float* other = Sx + (warp ^ F::RW) * W + lane;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(4 * j + e) * 32] = a1[j][e];
        mine[(4 * (NS + j) + e) * 32] = a2[j][e];
      }
    asm volatile("bar.sync %0, 64;" ::"r"(1 + warp % F::RW) : "memory");
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a1[j][e] += other[(4 * j + e) * 32];
        a2[j][e] += other[(4 * (NS + j) + e) * 32];
      }
  }
}

// a score tile as the A fragments of the next product (its columns become
// the k slots: elements 0, 2, 1, 3), split
template <bool X3, int NS>
__device__ __forceinline__ void split_tile(const float (&a)[NS][4],
                                           uint32_t (&b)[NS][4],
                                           uint32_t (&s)[NS][4]) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    split<X3>(a[j][0], b[j][0], s[j][0]);
    split<X3>(a[j][2], b[j][1], s[j][1]);
    split<X3>(a[j][1], b[j][2], s[j][2]);
    split<X3>(a[j][3], b[j][3], s[j][3]);
  }
}

// acc += A Y over the warp's hd columns [d0, d0 + HDW): A a split score
// tile (k slots: streamed rows 8 j + pi(2t), 8 j + pi(2t + 1)), Y the
// stage's streamed rows, read down their columns.  Each pass of NG output
// n-tiles is summed from zero over the step and added into acc.
template <bool X3, class F>
__device__ __forceinline__ void accumulate(float (&acc)[F::NO][4],
                                           const uint32_t (&ab)[F::NS][4],
                                           const uint32_t (&as)[F::NS][4],
                                           const float* Y, int d0, int g,
                                           int p0, int p1) {
  constexpr int ST = F::ST, NG = F::NG;
#pragma unroll
  for (int n0 = 0; n0 < F::NO; n0 += NG) {
    float d[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < F::NS; ++j) {
      const float* y0 = Y + (8 * j + p0) * ST + d0 + 8 * n0 + g;
      const float* y1 = Y + (8 * j + p1) * ST + d0 + 8 * n0 + g;
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        uint32_t bb[2], bs[2];
        split_exact<X3>(y0[8 * n], bb[0], bs[0]);
        split_exact<X3>(y1[8 * n], bb[1], bs[1]);
        mma3<X3>(d[n], ab[j], as[j], bb, bs);
      }
    }
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += d[n][e];
  }
}

// rows [r0, r0 + n) of a (T, hd) operand into shared rows of stride ST
// (f32 by cp.async, bf16 widened); rows at or past `limit` are zeros
template <typename T, class F>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, long long r0, int n,
                                      long long limit, int tid) {
  constexpr int HD = F::HD, ST = F::ST;
  for (int i = tid; i < n * HD / 4; i += F::THREADS) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    const bool ok = r0 + r < limit;
    load4(dst + r * ST + c, src + (ok ? r0 + r : 0) * stride + c, ok);
  }
}

// non-finite gradients from the fast path: count the CTA, ask for the exact
// path (every thread of the CTA calls it)
__device__ __forceinline__ void check_finite(bool bad, const Params& p) {
  if (__syncthreads_or(bad) && threadIdx.x == 0) {
    atomicAdd(p.recomputes, 1);
    p.flag[1] = 1;
  }
}

// 2. dq
template <typename T, int HD>
__global__ void __launch_bounds__(Fast<HD>::THREADS, Fast<HD>::MIN_BLOCKS)
    flash_bwd_dq(const T* __restrict__ Q, const T* __restrict__ K,
                 const T* __restrict__ V, const T* __restrict__ dO,
                 T* __restrict__ dQ, const Params p) {
  using F = Fast<HD>;
  constexpr int R = F::R, BS = F::BS, ST = F::ST, NS = F::NS, NO = F::NO;
  constexpr bool X3 = std::is_same<T, float>::value;
  if (p.flag[0]) return;  // the exact path takes every tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [R][ST]
  float* dOs = Qs + R * ST;         // [R][ST]
  float* ring = dOs + R * ST;       // 2 stages of K [BS][ST], V [BS][ST]
  float* Sx = ring + 2 * F::STAGE + F::ROWS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % F::RW, d0 = (warp / F::RW) * F::HDW;
  const int pg = pi(g), p0 = pi(2 * t), p1 = pi(2 * t + 1);
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / p.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;  // heavy tiles first
  const T* q = Q + b * p.qs[0] + h * p.qs[1];
  const T* k = K + b * p.ks[0] + kvh * p.ks[1];
  const T* v = V + b * p.vs[0] + kvh * p.vs[1];
  const T* go = dO + b * p.dos[0] + h * p.dos[1];
  T* dq = dQ + b * p.dqs[0] + h * p.dqs[1];
  const long long row0 = ((long long)b * p.H + h) * p.Tq;

  // the key tiles the tile's rows can see (a row's lo and hi grow with it)
  long long lo, hi, lo_last, hi_last;
  visible((long long)p.q_offset + q0, p, lo, hi);
  visible((long long)p.q_offset + min(q0 + R, p.Tq) - 1, p, lo_last,
          hi_last);
  const int t_lo = (int)(lo / BS);
  const int t_hi = hi_last < lo ? t_lo - 1 : (int)(hi_last / BS);

  stage<T, F>(Qs, q, p.qs[2], q0, R, p.Tq, tid);
  stage<T, F>(dOs, go, p.dos[2], q0, R, p.Tq, tid);
  auto load_kv = [&](int tile, int s) {
    float* Ks = ring + s * F::STAGE;
    stage<T, F>(Ks, k, p.ks[2], (long long)tile * BS, BS, p.Tkv, tid);
    stage<T, F>(Ks + BS * ST, v, p.vs[2], (long long)tile * BS, BS, p.Tkv,
                tid);
  };
  if (t_lo <= t_hi) load_kv(t_lo, 0);
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  int row[2];
  long long qpos[2];
  float lse[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + 16 * rg + g + 8 * r;
    qpos[r] = (long long)p.q_offset + row[r];
    const bool ok = row[r] < p.Tq;
    lse[r] = ok ? p.lse[row0 + row[r]] : 0.f;
    Dr[r] = ok ? p.D[row0 + row[r]] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = t_lo; it <= t_hi; ++it) {
    const int s = (it - t_lo) & 1;
    cp_async_wait<0>();  // tile `it` has landed (this thread's part)
    __syncthreads();     // ... everyone's, and slot s ^ 1 is free
    if (it < t_hi) load_kv(it + 1, s ^ 1);
    cp_async_commit();
    const float* Ks = ring + s * F::STAGE;
    const float* Vs = Ks + BS * ST;
    const int k0 = it * BS;
    float sc[NS][4], dp[NS][4];
    scores2<X3, F>(Qs + 16 * rg * ST, Ks, dOs + 16 * rg * ST, Vs, d0, g, t,
                   pg, sc, dp);
    swap_halves<F>(Sx, warp, lane, sc, dp);
    // P = exp(scale S - lse) on the visible keys (0 elsewhere), dS into sc
    // (element e of n-tile j: row g + 8 (e >> 1), key 8 j + pi(2t + (e & 1)))
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + 8 * j + ((e & 1) ? p1 : p0);
        const float pr = sees(qpos[r], kpos, row[r] < p.Tq, p)
                             ? expf(sc[j][e] * p.scale - lse[r])
                             : 0.f;
        sc[j][e] = pr * (dp[j][e] - Dr[r]);
      }
    uint32_t ab[NS][4], as[NS][4];
    split_tile<X3, NS>(sc, ab, as);
    accumulate<X3, F>(acc, ab, as, Ks, d0, g, p0, p1);  // dQ += dS K
  }
  cp_async_wait<0>();

  bool bad = false;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (row[r] < p.Tq)
#pragma unroll
      for (int n = 0; n < NO; ++n)
        bad |= !(isfinite(acc[n][2 * r]) && isfinite(acc[n][2 * r + 1]));
  check_finite(bad, p);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Tq) continue;
    T* out = dq + (long long)row[r] * p.dqs[2] + d0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(out + 8 * n, acc[n][2 * r] * p.scale,
             acc[n][2 * r + 1] * p.scale);
  }
}

// 3. dk and dv (or their partials for one share of the group's q heads)
template <typename T, int HD>
__global__ void __launch_bounds__(Fast<HD>::THREADS, Fast<HD>::MIN_BLOCKS)
    flash_bwd_dkv(const T* __restrict__ Q, const T* __restrict__ K,
                  const T* __restrict__ V, const T* __restrict__ dO,
                  T* __restrict__ dK, T* __restrict__ dV, const Params p) {
  using F = Fast<HD>;
  constexpr int R = F::R, BS = F::BS, ST = F::ST, NS = F::NS, NO = F::NO;
  constexpr bool X3 = std::is_same<T, float>::value;
  if (p.flag[0]) return;  // the exact path takes every tile
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // [R][ST] the CTA's keys
  float* Vs = Ks + R * ST;           // [R][ST]
  float* ring = Vs + R * ST;         // 2 stages of Q [BS][ST], dO [BS][ST]
  float* rows = ring + 2 * F::STAGE; // 2 stages of lse [BS], D [BS]
  float* Sx = rows + F::ROWS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % F::RW, d0 = (warp / F::RW) * F::HDW;
  const int pg = pi(g), p0 = pi(2 * t), p1 = pi(2 * t + 1);
  const int sp = blockIdx.y % p.splits;  // the share of the group's heads
  const int bk = blockIdx.y / p.splits;  // b KV + kv head
  const int b = bk / p.KV, kvh = bk % p.KV;
  const int k0 = blockIdx.x * R;  // early (heavy under causal) tiles first
  const T* k = K + b * p.ks[0] + kvh * p.ks[1];
  const T* v = V + b * p.vs[0] + kvh * p.vs[1];
  const int share = (p.group + p.splits - 1) / p.splits;
  const int h_lo = kvh * p.group + min(p.group, sp * share);
  const int h_hi = kvh * p.group + min(p.group, (sp + 1) * share);

  // q rows that can see a key of [k0, kl]: qpos >= k0 (causal) and
  // qpos - kl < window; the steps walk (head, q tile) pairs in order
  const int kl = min(k0 + R, p.Tkv) - 1;
  long long i_lo = 0, i_hi = p.Tq - 1;
  if (p.causal) i_lo = max(i_lo, (long long)k0 - p.q_offset);
  if (p.window > 0)
    i_hi = min(i_hi, (long long)kl + p.window - 1 - p.q_offset);
  const int qt_lo = i_lo > i_hi ? 0 : (int)(i_lo / BS);
  const int n_qt = i_lo > i_hi ? 0 : (int)(i_hi / BS) - qt_lo + 1;
  const int n_it = (h_hi - h_lo) * n_qt;

  stage<T, F>(Ks, k, p.ks[2], k0, R, p.Tkv, tid);
  stage<T, F>(Vs, v, p.vs[2], k0, R, p.Tkv, tid);
  auto load_q = [&](int it, int s) {
    const int h = h_lo + it / n_qt;
    const long long i0 = (long long)(qt_lo + it % n_qt) * BS;
    float* Qt = ring + s * F::STAGE;
    stage<T, F>(Qt, Q + b * p.qs[0] + h * p.qs[1], p.qs[2], i0, BS, p.Tq,
                tid);
    stage<T, F>(Qt + BS * ST, dO + b * p.dos[0] + h * p.dos[1], p.dos[2], i0,
                BS, p.Tq, tid);
    if (tid < BS) {
      const long long i = ((long long)b * p.H + h) * p.Tq + i0 + tid;
      const bool ok = i0 + tid < p.Tq;
      rows[s * 2 * BS + tid] = ok ? p.lse[i] : 0.f;
      rows[s * 2 * BS + BS + tid] = ok ? p.D[i] : 0.f;
    }
  };
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  // this thread's keys: g and g + 8 of the warp's 16
  int key[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) key[r] = k0 + 16 * rg + g + 8 * r;
  float ak[NO][4], av[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int s = it & 1;
    cp_async_wait<0>();  // step `it` has landed (this thread's part)
    __syncthreads();     // ... everyone's, and slot s ^ 1 is free
    if (it + 1 < n_it) load_q(it + 1, s ^ 1);
    cp_async_commit();
    const float* Qt = ring + s * F::STAGE;
    const float* dOt = Qt + BS * ST;
    const float* lse_s = rows + s * 2 * BS;
    const float* D_s = lse_s + BS;
    const int i0 = (qt_lo + it % n_qt) * BS;
    // S^T = K Q^T and dP^T = V dO^T: the keys are the rows
    float sc[NS][4], dp[NS][4];
    scores2<X3, F>(Ks + 16 * rg * ST, Qt, Vs + 16 * rg * ST, dOt, d0, g, t,
                   pg, sc, dp);
    swap_halves<F>(Sx, warp, lane, sc, dp);
    // P^T into sc, dS^T into dp (element e of n-tile j: key g + 8 (e >> 1),
    // q row i0 + 8 j + pi(2t + (e & 1)))
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + ((e & 1) ? p1 : p0);
        const long long qpos = (long long)p.q_offset + i0 + c;
        const float pr = sees(qpos, key[e >> 1], i0 + c < p.Tq, p)
                             ? expf(sc[j][e] * p.scale - lse_s[c])
                             : 0.f;
        sc[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - D_s[c]);
      }
    uint32_t ab[NS][4], as[NS][4];
    split_tile<X3, NS>(sc, ab, as);
    accumulate<X3, F>(av, ab, as, dOt, d0, g, p0, p1);  // dV += P^T dO
    split_tile<X3, NS>(dp, ab, as);
    accumulate<X3, F>(ak, ab, as, Qt, d0, g, p0, p1);   // dK += dS^T Q
  }
  cp_async_wait<0>();

  // rows with no visible key: weight 1 / Tkv on every key in the plain
  // softmax, so dO / Tkv on every key's dv ([0, m_hi] before every key
  // under the causal mask, [w_lo, Tq) past the window)
  const float inv = 1.f / (float)p.Tkv;
  long long m_hi = -1, w_lo = p.Tq;
  if (p.causal) m_hi = min((long long)p.Tq, -(long long)p.q_offset) - 1;
  if (p.window > 0)
    w_lo = max((long long)0, (long long)p.Tkv + p.window - 1 - p.q_offset);
  w_lo = max(w_lo, m_hi + 1);
  for (int h = h_lo; h < h_hi; ++h) {
    const T* go = dO + b * p.dos[0] + h * p.dos[1] + d0 + 2 * t;
    for (int pass = 0; pass < 2; ++pass) {
      const long long a0 = pass ? w_lo : 0, a1 = pass ? p.Tq - 1 : m_hi;
      for (long long i = a0; i <= a1; ++i) {
        const T* gi = go + i * p.dos[2];
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const float x0 = widen(gi[8 * n]), x1 = widen(gi[8 * n + 1]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            av[n][2 * r] = fmaf(x0, inv, av[n][2 * r]);
            av[n][2 * r + 1] = fmaf(x1, inv, av[n][2 * r + 1]);
          }
        }
      }
    }
  }

  bool bad = false;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (key[r] < p.Tkv)
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          bad |= !(isfinite(ak[n][e]) && isfinite(av[n][e]));
  check_finite(bad, p);
  const long long per = (long long)p.B * p.KV * p.Tkv * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.Tkv) continue;
    if (p.splits == 1) {
      T* dk = dK + b * p.dks[0] + kvh * p.dks[1] + (long long)key[r] * p.dks[2]
              + d0 + 2 * t;
      T* dv = dV + b * p.dvs[0] + kvh * p.dvs[1] + (long long)key[r] * p.dvs[2]
              + d0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        store2(dk + 8 * n, ak[n][2 * r] * p.scale, ak[n][2 * r + 1] * p.scale);
        store2(dv + 8 * n, av[n][2 * r], av[n][2 * r + 1]);
      }
    } else {
      float* pk = p.part + sp * per + ((long long)bk * p.Tkv + key[r]) * HD
                  + d0 + 2 * t;
      float* pv = pk + p.splits * per;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        store2(pk + 8 * n, ak[n][2 * r], ak[n][2 * r + 1]);
        store2(pv + 8 * n, av[n][2 * r], av[n][2 * r + 1]);
      }
    }
  }
}

// 4. dk and dv as the partials' sum in split order (splits > 1)
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_sum(T* __restrict__ dK, T* __restrict__ dV, const Params p,
                      int HD) {
  if (p.flag[0]) return;
  const long long per = (long long)p.B * p.KV * p.Tkv * HD;
  bool bad = false;
  for (long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) * 4;
       i < per; i += (long long)gridDim.x * THREADS * 4) {
    float4 sk = read4(p.part + i), sv = read4(p.part + p.splits * per + i);
    for (int s = 1; s < p.splits; ++s) {
      const float4 a = read4(p.part + s * per + i);
      const float4 c = read4(p.part + (p.splits + s) * per + i);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    sk.x *= p.scale; sk.y *= p.scale; sk.z *= p.scale; sk.w *= p.scale;
    bad |= !(isfinite(sk.x) && isfinite(sk.y) && isfinite(sk.z) &&
             isfinite(sk.w) && isfinite(sv.x) && isfinite(sv.y) &&
             isfinite(sv.z) && isfinite(sv.w));
    const int col = (int)(i % HD);
    const long long row = i / HD;  // (b KV + kv head) Tkv + key
    const long long key = row % p.Tkv, bk = row / p.Tkv;
    const long long b = bk / p.KV, kvh = bk % p.KV;
    T* dk = dK + b * p.dks[0] + kvh * p.dks[1] + key * p.dks[2] + col;
    T* dv = dV + b * p.dvs[0] + kvh * p.dvs[1] + key * p.dvs[2] + col;
    store2(dk, sk.x, sk.y);
    store2(dk + 2, sk.z, sk.w);
    store2(dv, sv.x, sv.y);
    store2(dv + 2, sv.z, sv.w);
  }
  check_finite(bad, p);
}

// -- the exact path ---------------------------------------------------------

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

// 5. dq on the exact path: one q row per warp, the plain version's autograd
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_exact(const T* __restrict__ Q, const T* __restrict__ K,
                       const T* __restrict__ V, const T* __restrict__ dO,
                       T* __restrict__ dQ, const Params p) {
  if (!p.flag[0] && !p.flag[1]) return;
  constexpr int DL = (HD + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kvh = h / p.group;
  const T* q = Q + b * p.qs[0] + h * p.qs[1];
  const T* k = K + b * p.ks[0] + kvh * p.ks[1];
  const T* v = V + b * p.vs[0] + kvh * p.vs[1];
  const T* g = dO + b * p.dos[0] + h * p.dos[1];
  T* dq = dQ + b * p.dqs[0] + h * p.dqs[1];
  float* stats = p.stats + ((long long)b * p.H + h) * p.Tq * NSTAT;
  const int q0 = blockIdx.x * EX;
  for (int r = warp; r < EX && q0 + r < p.Tq; r += THREADS / 32) {
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

// 6. dk and dv on the exact path: one key per warp over every q row of the
// group
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_exact(const T* __restrict__ Q, const T* __restrict__ K,
                        const T* __restrict__ V, const T* __restrict__ dO,
                        T* __restrict__ dK, T* __restrict__ dV,
                        const Params p) {
  if (!p.flag[0] && !p.flag[1]) return;
  constexpr int DL = (HD + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y / p.KV, kvh = blockIdx.y % p.KV;
  const T* k = K + b * p.ks[0] + kvh * p.ks[1];
  const T* v = V + b * p.vs[0] + kvh * p.vs[1];
  T* dk = dK + b * p.dks[0] + kvh * p.dks[1];
  T* dv = dV + b * p.dvs[0] + kvh * p.dvs[1];
  const int k0 = blockIdx.x * EX;
  for (int jj = warp; jj < EX && k0 + jj < p.Tkv; jj += THREADS / 32) {
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
      const float* st = p.stats + ((long long)b * p.H + h) * p.Tq * NSTAT;
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

// -- launch -----------------------------------------------------------------

template <typename T, int HD>
cudaError_t set_smem() {
  const int smem = (int)(sizeof(float) * Fast<HD>::SMEM_FLOATS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_bwd_dkv<T, HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* dO,
              void* dq, void* dk, void* dv, const Params& p,
              cudaStream_t s) {
  using F = Fast<HD>;
  const T *Q = static_cast<const T*>(q), *K = static_cast<const T*>(k),
          *V = static_cast<const T*>(v), *G = static_cast<const T*>(dO);
  T *dQ = static_cast<T*>(dq), *dK = static_cast<T*>(dk),
    *dV = static_cast<T*>(dv);
  cudaError_t err = set_smem<T, HD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * F::SMEM_FLOATS;
  flash_bwd_dq<T, HD><<<dim3((p.Tq + F::R - 1) / F::R, p.B * p.H),
                         F::THREADS, smem, s>>>(Q, K, V, G, dQ, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv<T, HD><<<dim3((p.Tkv + F::R - 1) / F::R,
                              p.B * p.KV * p.splits),
                         F::THREADS, smem, s>>>(Q, K, V, G, dK, dV, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (p.splits > 1) {
    const long long n4 = (long long)p.B * p.KV * p.Tkv * HD / 4;
    const long long blocks = (n4 + THREADS - 1) / THREADS;
    flash_bwd_dkv_sum<T><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                           THREADS, 0, s>>>(dK, dV, p, HD);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  // the exact path (it returns at once unless a flag is set); dq first: it
  // writes the row statistics dkv reads
  flash_bwd_dq_exact<T, HD><<<dim3((p.Tq + EX - 1) / EX, p.B * p.H), THREADS,
                              0, s>>>(Q, K, V, G, dQ, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_exact<T, HD><<<dim3((p.Tkv + EX - 1) / EX, p.B * p.KV),
                               THREADS, 0, s>>>(Q, K, V, G, dK, dV, p);
  return static_cast<int>(cudaGetLastError());
}

// dims: B, H, Tq, Tkv, hd, group, causal, window (0 = none), q_offset,
// splits, then the b, h, t element strides of q, k, v, o, dO, dq, dk and dv
// (24 values)
Params parse(const long long* dims) {
  Params p{};
  p.B = (int)dims[0];
  p.H = (int)dims[1];
  p.Tq = (int)dims[2];
  p.Tkv = (int)dims[3];
  p.group = (int)dims[5];
  p.KV = p.H / p.group;
  p.causal = (int)dims[6];
  p.window = (int)dims[7];
  p.q_offset = (int)dims[8];
  p.splits = (int)dims[9];
  long long* strides[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int a = 0; a < 8; ++a)
    for (int i = 0; i < 3; ++i) strides[a][i] = dims[10 + 3 * a + i];
  return p;
}

// lse: the forward's (B, H, Tq) fp32; D: (B, H, Tq), stats: (B, H, Tq, 6)
// and part: (2, splits, B, KV, Tkv, hd) fp32 scratch (part unused when
// splits = 1); flag: two device ints of scratch; recomputes: the device
// counter
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const void* lse, void* dq, void* dk, void* dv,
           const long long* dims, float scale, void* D, void* stats,
           void* flag, void* part, void* recomputes, void* stream) {
  Params p = parse(dims);
  const int hd = (int)dims[4];
  p.scale = scale;
  p.lse = static_cast<const float*>(lse);
  p.D = static_cast<float*>(D);
  p.stats = static_cast<float*>(stats);
  p.part = static_cast<float*>(part);
  p.flag = static_cast<int*>(flag);
  p.recomputes = static_cast<int*>(recomputes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256) ||
      p.splits < 1 || p.splits > p.group)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(flag, 0, 2 * sizeof(int), s);
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
    default: return launch_hd<T, 256>(q, k, v, dO, dq, dk, dv, p, s);
  }
}

}  // namespace

extern "C" int repro_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv,
    const long long* dims, float scale, void* D, void* stats, void* flag,
    void* part, void* recomputes, void* stream) {
  return launch<float>(q, k, v, o, dO, lse, dq, dk, dv, dims, scale, D, stats,
                       flag, part, recomputes, stream);
}

extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv,
    const long long* dims, float scale, void* D, void* stats, void* flag,
    void* part, void* recomputes, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dO, lse, dq, dk, dv, dims, scale,
                               D, stats, flag, part, recomputes, stream);
}
