// Device bodies and launchers of the port's training attention kernels,
// shared by splash_attention.cu (TPU kernels #9/#10) and flash_attention.cu
// (#5-#8). Each source defines its own __global__ kernels (so a profile
// names them apart) as thin wrappers around the bodies here.
//
// Layouts: q [b, sq, nh, d], k/v [b, sk, kvh, d] as strided views (any
// batch, row and head strides, unit stride along d: the wrappers pass
// qkv.reshape(b, s, 3, nh, d)[:, :, i] without a copy); segment ids
// [b, sq] int32 or null (keys use the same table: seg[:, :sk]); out, dq
// [b, sq, nh, d], dk, dv [b, sk, kvh, d] and dout contiguous; the row
// statistics (lse, delta, and the single-block path's row sum) [b, nh, sq]
// fp32. Head h reads kv head h / (nh / kvh). Key j is visible to row i when
// j < sk, (not causal or j <= i) and seg[i] == seg[j]; the [s, s] mask never
// exists. A row with no visible key gets output 0, lse = +inf and zero
// gradients (exp(s - inf) = 0 exactly).
//
// Design: 128 threads a block, 64-row tiles staged in shared memory, the
// products in tile_mma.cuh (wmma on the tensor cores in bf16, CUDA cores in
// fp32).
//   forward (`fwd_body`): one block per (64 query rows, head, batch); it
//     walks the key tiles in order with an online softmax (m, l, O in
//     shared memory) and skips key tiles wholly above the diagonal. P is
//     cast to the value dtype before P.V unnormalised, and O is divided by
//     l at the end. A tile that is fully masked (segments) leaves the
//     running stats as they were.
//   backward: delta = rowsum(dO * O) first (`delta_body`); then one block
//     per (64 keys, kv head, batch) walks the group's query heads and the
//     query tiles at or below the diagonal, accumulating dK and dV in
//     shared memory (`dkdv_body`); and one block per (64 query rows, head,
//     batch) walks the key tiles, accumulating dQ (`dq_body`). Every sum
//     lives inside one block and runs in a fixed order: no atomics, so the
//     gradients are bit-reproducible. The price is that S and P are
//     recomputed in both kernels.
//   Probabilities: p = exp(s * scale - lse) from the forward's logsumexp,
//     or, with kNorm (the flash single-block backward, which keeps the TPU
//     kernel's exact softmax), p = exp(s * scale - m) / l from the row max
//     and sum; with kStats the dQ body first computes m, l and
//     delta = sum_j p_j dP_j itself, over every key tile, and stores them
//     for the dK/dV kernel that runs after it.
#pragma once

#include "tile_mma.cuh"

namespace attn {

using tile::from_f;
using tile::kThreads;
using tile::to_f;

constexpr int kB = 64;        // rows of every tile: query rows and keys
constexpr int kMaxHeadDim = 128;

struct View {                 // element strides of a [b, s, heads, d] view
  long long b, s, h;
};

struct Geometry {
  int sq, sk, nh, kvh, d, causal;
  float scale;
};

// Row statistics of the backward, each [b, nh, sq] fp32: the logsumexp
// (or, with kNorm, the row max), the row sum of exp(s - max) (kNorm only,
// else null) and delta.
struct Stats {
  float* lse;
  float* norm;
  float* delta;
};

// The mask of (row i, key j) with the tile's segment ids.
__device__ __forceinline__ bool visible(const Geometry& g, int i, int j,
                                        int seg_i, int seg_j) {
  return i < g.sq && j < g.sk && (!g.causal || j <= i) && seg_i == seg_j;
}

// Segment ids of rows [r0, r0 + 64) into s; rows past `n` get `pad` (never
// equal to a real id of the other side, which pads with pad - 1).
__device__ __forceinline__ void stage_seg(int* s, const int* seg, int b,
                                          int sq, int r0, int n, int pad) {
  if (threadIdx.x < kB) {
    const int i = r0 + threadIdx.x;
    s[threadIdx.x] = i < n ? (seg ? seg[(size_t)b * sq + i] : 0) : pad;
  }
}

// Key tiles a query tile starting at q0 with `rows` rows reads.
__device__ __forceinline__ int key_tiles(const Geometry& g, int q0,
                                         int rows) {
  const int nk = (g.sk + kB - 1) / kB;
  return g.causal ? min(nk, (q0 + rows - 1) / kB + 1) : nk;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T>
size_t fwd_smem(int d) {
  const int pd = tile::pitch<T>(d), pp = tile::pitch<T>(kB);
  size_t off = 0;
  tile::take(off, 3 * kB * pd * sizeof(T));       // Q, K, V
  tile::take(off, kB * (kB + 4) * sizeof(float));  // S
  tile::take(off, kB * pp * sizeof(T));            // P
  tile::take(off, kB * (d + 4) * sizeof(float));   // O
  tile::take(off, 3 * kB * sizeof(float));         // m, l, corr
  tile::take(off, 2 * kB * sizeof(int));           // segments
  return off;
}

// The forward's shared memory, carved in fwd_smem's order.
template <typename T>
struct FwdTiles {
  T *q, *k, *v, *p;
  float *s, *o, *m, *l, *c;
  int *segq, *segk;
  __device__ FwdTiles(unsigned char* base, int d) {
    const int pd = tile::pitch<T>(d), pp = tile::pitch<T>(kB);
    size_t off = 0;
    q = (T*)(base + tile::take(off, 3 * kB * pd * sizeof(T)));
    k = q + kB * pd;
    v = k + kB * pd;
    s = (float*)(base + tile::take(off, kB * (kB + 4) * sizeof(float)));
    p = (T*)(base + tile::take(off, kB * pp * sizeof(T)));
    o = (float*)(base + tile::take(off, kB * (d + 4) * sizeof(float)));
    m = (float*)(base + tile::take(off, 3 * kB * sizeof(float)));
    l = m + kB;
    c = l + kB;
    segq = (int*)(base + tile::take(off, 2 * kB * sizeof(int)));
    segk = segq + kB;
  }
};

template <typename T>
__device__ __forceinline__ void fwd_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, const int* __restrict__ seg,
    View qv, View kv, View vv, Geometry g) {
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (g.nh / g.kvh);
  const int q0 = qt * kB, rows = min(kB, g.sq - q0);
  const int d = g.d;
  const int pd = tile::pitch<T>(d), pp = tile::pitch<T>(kB);
  const int ps = kB + 4, po = d + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(128) unsigned char smem[];
  FwdTiles<T> t(smem, d);

  tile::stage(t.q, pd, q + b * qv.b + q0 * qv.s + h * qv.h, qv.s, kB, rows,
              d);
  for (int idx = tid; idx < kB * d; idx += kThreads)
    t.o[(idx / d) * po + idx % d] = 0.f;
  if (tid < kB) {
    t.m[tid] = -INFINITY;
    t.l[tid] = 0.f;
  }
  stage_seg(t.segq, seg, b, g.sq, q0, g.sq, -1);
  const int n_kt = key_tiles(g, q0, rows);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB, kr = min(kB, g.sk - k0);
    __syncthreads();   // the last tile's P.V has read K, V, P
    tile::stage(t.k, pd, k + b * kv.b + k0 * kv.s + kh * kv.h, kv.s, kB, kr,
                d);
    tile::stage(t.v, pd, v + b * vv.b + k0 * vv.s + kh * vv.h, vv.s, kB, kr,
                d);
    stage_seg(t.segk, seg, b, g.sq, k0, g.sk, -2);
    __syncthreads();
    tile::mma<T, false, true>(t.s, ps, t.q, pd, t.k, pd, kB, kB, d, false);
    __syncthreads();

    // online softmax: one warp per row, two keys per lane
    for (int r = warp; r < kB; r += kThreads / 32) {
      const int i = q0 + r;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        x[e] = visible(g, i, k0 + j, t.segq[r], t.segk[j])
                   ? t.s[r * ps + j] * g.scale
                   : -INFINITY;
      }
      const float m_prev = t.m[r];
      const float m_new = fmaxf(m_prev, tile::warp_max(fmaxf(x[0], x[1])));
      float p0 = 0.f, p1 = 0.f, corr = 1.f;
      // a fully masked tile keeps the empty state: no exp(-inf - -inf)
      if (m_new != -INFINITY) {
        p0 = expf(x[0] - m_new);
        p1 = expf(x[1] - m_new);
        corr = expf(m_prev - m_new);
      }
      t.p[r * pp + lane] = from_f<T>(p0);
      t.p[r * pp + lane + 32] = from_f<T>(p1);
      const float sum = tile::warp_sum(p0 + p1);
      if (lane == 0) {
        t.l[r] = corr * t.l[r] + sum;
        t.m[r] = m_new;
        t.c[r] = corr;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kB * d; idx += kThreads) {
      const int r = idx / d;
      t.o[r * po + idx - r * d] *= t.c[r];
    }
    __syncthreads();
    tile::mma<T, false, false>(t.o, po, t.p, pp, t.v, pd, kB, d, kB, true);
  }
  __syncthreads();

  for (int idx = tid; idx < rows * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const float l = t.l[r];
    out[(((size_t)b * g.sq + q0 + r) * g.nh + h) * d + c] =
        from_f<T>(t.o[r * po + c] / (l == 0.f ? 1.f : l));
  }
  if (tid < rows) {
    const float l = t.l[tid];
    lse[((size_t)b * g.nh + h) * g.sq + q0 + tid] =
        l > 0.f ? t.m[tid] + logf(l) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// delta[b, h, i] = sum_d dO * O in fp32: one warp per (b, i, h) row.
template <typename T>
__device__ __forceinline__ void delta_body(const T* __restrict__ out,
                                           const T* __restrict__ dout,
                                           float* __restrict__ delta,
                                           long long n_rows, int sq, int nh,
                                           int d) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const T* o = out + row * d;
  const T* dd = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f(dd[c]), to_f(o[c]), acc);
  acc = tile::warp_sum(acc);
  if (lane == 0) {
    const long long bi = row / nh;          // b * sq + i
    const int h = (int)(row - bi * nh);
    const long long b = bi / sq;
    delta[(b * nh + h) * sq + (bi - b * sq)] = acc;
  }
}

// Shared memory of both gradient kernels: four operand tiles (T), S and dP
// (fp32), P or dS (T), the fp32 accumulators [64][d] (dK and dV, or dQ),
// `n_stats` row statistics (lse and delta; the row sum too with kNorm) and
// the segment ids. The accumulators go unpadded (only the products and the
// final copy-out touch them): at d = 64 in bf16 that brings the dK/dV
// kernel to 112 KB, so two of its blocks fit an SM.
template <typename T>
size_t bwd_smem(int d, int n_acc, int n_stats = 2) {
  const int pd = tile::pitch<T>(d), pp = tile::pitch<T>(kB);
  size_t off = 0;
  tile::take(off, 4 * kB * pd * sizeof(T));
  tile::take(off, 2 * kB * (kB + 4) * sizeof(float));
  tile::take(off, kB * pp * sizeof(T));
  tile::take(off, n_acc * kB * d * sizeof(float));
  tile::take(off, n_stats * kB * sizeof(float));
  tile::take(off, 2 * kB * sizeof(int));
  return off;
}

struct BwdSmem {
  unsigned char* base;
  size_t off = 0;
  template <typename X>
  __device__ X* take(size_t n) {
    return (X*)(base + tile::take(off, n * sizeof(X)));
  }
};

// p of row i, key j where visible, else 0 (s: the raw product, fp32):
// exp(s * scale - lse), or with kNorm exp(s * scale - m) / l.
template <bool kNorm>
__device__ __forceinline__ float prob(const Geometry& g, float s, float lse_r,
                                      float norm_r, int i, int j, int seg_i,
                                      int seg_j) {
  if (!visible(g, i, j, seg_i, seg_j)) return 0.f;
  const float e = expf(s * g.scale - lse_r);
  return kNorm ? e / norm_r : e;
}

// Stage the row statistics of query rows [q0, q0 + qr) of head h; rows past
// the end read as empty (lse +inf: p = 0).
template <bool kNorm>
__device__ __forceinline__ void stage_stats(float* lse_s, float* norm_s,
                                            float* delta_s, const Stats& st,
                                            int b, int h, int q0, int qr,
                                            const Geometry& g) {
  const int tid = threadIdx.x;
  if (tid < kB) {
    const bool in = tid < qr;
    const size_t at = ((size_t)b * g.nh + h) * g.sq + q0 + tid;
    lse_s[tid] = in ? st.lse[at] : INFINITY;
    delta_s[tid] = in ? st.delta[at] : 0.f;
    if constexpr (kNorm) norm_s[tid] = in ? st.norm[at] : 1.f;
  }
}

template <typename T, bool kNorm>
__device__ __forceinline__ void dkdv_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, Stats st, const int* __restrict__ seg,
    T* __restrict__ dk, T* __restrict__ dv, View qv, View kv, View vv,
    Geometry g) {
  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kB, kr = min(kB, g.sk - k0);
  const int d = g.d, grp = g.nh / g.kvh;
  const int pd = tile::pitch<T>(d), pp = tile::pitch<T>(kB);
  const int ps = kB + 4, po = d;
  const int tid = threadIdx.x;
  const View ov{(long long)g.sq * g.nh * d, (long long)g.nh * d, d};

  extern __shared__ __align__(128) unsigned char smem[];
  BwdSmem sm{smem};
  T* k_s = sm.take<T>(4 * kB * pd);
  T* v_s = k_s + kB * pd;
  T* q_s = v_s + kB * pd;
  T* do_s = q_s + kB * pd;
  float* s_s = sm.take<float>(2 * kB * ps);      // S, then P (fp32)
  float* dp_s = s_s + kB * ps;
  T* p_s = sm.take<T>(kB * pp);                  // P, then dS (T)
  float* dk_s = sm.take<float>(2 * kB * po);
  float* dv_s = dk_s + kB * po;
  float* lse_s = sm.take<float>((kNorm ? 3 : 2) * kB);
  float* delta_s = lse_s + kB;
  float* norm_s = delta_s + kB;                  // kNorm only
  int* segq = sm.take<int>(2 * kB);
  int* segk = segq + kB;

  tile::stage(k_s, pd, k + b * kv.b + k0 * kv.s + kh * kv.h, kv.s, kB, kr, d);
  tile::stage(v_s, pd, v + b * vv.b + k0 * vv.s + kh * vv.h, vv.s, kB, kr, d);
  stage_seg(segk, seg, b, g.sq, k0, g.sk, -2);
  for (int idx = tid; idx < 2 * kB * po; idx += kThreads) dk_s[idx] = 0.f;

  const int nq = (g.sq + kB - 1) / kB;
  const int qt0 = g.causal ? k0 / kB : 0;   // tiles above the diagonal: none
  for (int gi = 0; gi < grp; ++gi) {
    const int h = kh * grp + gi;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * kB, qr = min(kB, g.sq - q0);
      __syncthreads();   // the last tile's products are done
      tile::stage(q_s, pd, q + b * qv.b + q0 * qv.s + h * qv.h, qv.s, kB, qr,
                  d);
      tile::stage(do_s, pd, dout + b * ov.b + q0 * ov.s + h * ov.h, ov.s, kB,
                  qr, d);
      stage_stats<kNorm>(lse_s, norm_s, delta_s, st, b, h, q0, qr, g);
      stage_seg(segq, seg, b, g.sq, q0, g.sq, -1);
      __syncthreads();
      tile::mma<T, false, true>(s_s, ps, q_s, pd, k_s, pd, kB, kB, d, false);
      __syncthreads();
      for (int idx = tid; idx < kB * kB; idx += kThreads) {
        const int r = idx / kB, j = idx - r * kB;
        const float p = prob<kNorm>(g, s_s[r * ps + j], lse_s[r],
                                    kNorm ? norm_s[r] : 1.f, q0 + r, k0 + j,
                                    segq[r], segk[j]);
        s_s[r * ps + j] = p;
        p_s[r * pp + j] = from_f<T>(p);
      }
      __syncthreads();
      // dV += P^T dO, dP = dO V^T
      tile::mma<T, true, false>(dv_s, po, p_s, pp, do_s, pd, kB, d, kB, true);
      tile::mma<T, false, true>(dp_s, ps, do_s, pd, v_s, pd, kB, kB, d, false);
      __syncthreads();
      for (int idx = tid; idx < kB * kB; idx += kThreads) {
        const int r = idx / kB, j = idx - r * kB;
        p_s[r * pp + j] = from_f<T>(s_s[r * ps + j] *
                                    (dp_s[r * ps + j] - delta_s[r]) * g.scale);
      }
      __syncthreads();
      // dK += dS^T Q
      tile::mma<T, true, false>(dk_s, po, p_s, pp, q_s, pd, kB, d, kB, true);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kr * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const size_t at = (((size_t)b * g.sk + k0 + r) * g.kvh + kh) * d + c;
    dk[at] = from_f<T>(dk_s[r * po + c]);
    dv[at] = from_f<T>(dv_s[r * po + c]);
  }
}

template <typename T, bool kNorm, bool kStats>
__device__ __forceinline__ void dq_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, Stats st, const int* __restrict__ seg,
    T* __restrict__ dq, View qv, View kv, View vv, Geometry g) {
  static_assert(kNorm || !kStats, "the stats pass gives the max and sum");
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (g.nh / g.kvh);
  const int q0 = qt * kB, qr = min(kB, g.sq - q0);
  const int d = g.d;
  const int pd = tile::pitch<T>(d), pp = tile::pitch<T>(kB);
  const int ps = kB + 4, po = d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const View ov{(long long)g.sq * g.nh * d, (long long)g.nh * d, d};

  extern __shared__ __align__(128) unsigned char smem[];
  BwdSmem sm{smem};
  T* q_s = sm.take<T>(4 * kB * pd);
  T* do_s = q_s + kB * pd;
  T* k_s = do_s + kB * pd;
  T* v_s = k_s + kB * pd;
  float* s_s = sm.take<float>(2 * kB * ps);
  float* dp_s = s_s + kB * ps;
  T* ds_s = sm.take<T>(kB * pp);
  float* dq_s = sm.take<float>(kB * po);
  float* lse_s = sm.take<float>((kNorm ? 3 : 2) * kB);
  float* delta_s = lse_s + kB;
  float* norm_s = delta_s + kB;                  // kNorm only
  int* segq = sm.take<int>(2 * kB);
  int* segk = segq + kB;

  tile::stage(q_s, pd, q + b * qv.b + q0 * qv.s + h * qv.h, qv.s, kB, qr, d);
  tile::stage(do_s, pd, dout + b * ov.b + q0 * ov.s + h * ov.h, ov.s, kB, qr,
              d);
  stage_seg(segq, seg, b, g.sq, q0, g.sq, -1);
  for (int idx = tid; idx < kB * po; idx += kThreads) dq_s[idx] = 0.f;
  const int n_kt = key_tiles(g, q0, qr);

  auto stage_keys = [&](int k0, int kr) {
    tile::stage(k_s, pd, k + b * kv.b + k0 * kv.s + kh * kv.h, kv.s, kB, kr,
                d);
    tile::stage(v_s, pd, v + b * vv.b + k0 * vv.s + kh * vv.h, vv.s, kB, kr,
                d);
    stage_seg(segk, seg, b, g.sq, k0, g.sk, -2);
  };

  if constexpr (kStats) {
    // The rows' max m, sum l = sum_j exp(s_j - m) and delta = sum_j p_j dP_j
    // over every visible key, online in fp32 (two products a key tile),
    // then stored for the dK/dV kernel.
    if (tid < kB) {
      lse_s[tid] = -INFINITY;
      norm_s[tid] = 0.f;
      delta_s[tid] = 0.f;
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * kB, kr = min(kB, g.sk - k0);
      __syncthreads();
      stage_keys(k0, kr);
      __syncthreads();
      tile::mma<T, false, true>(s_s, ps, q_s, pd, k_s, pd, kB, kB, d, false);
      tile::mma<T, false, true>(dp_s, ps, do_s, pd, v_s, pd, kB, kB, d,
                                false);
      __syncthreads();
      for (int r = warp; r < kB; r += kThreads / 32) {
        const int i = q0 + r;
        float x[2], dp[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = lane + 32 * e;
          x[e] = visible(g, i, k0 + j, segq[r], segk[j])
                     ? s_s[r * ps + j] * g.scale
                     : -INFINITY;
          dp[e] = dp_s[r * ps + j];
        }
        const float m_prev = lse_s[r];
        const float m_new = fmaxf(m_prev, tile::warp_max(fmaxf(x[0], x[1])));
        if (m_new != -INFINITY) {          // uniform over the warp
          const float e0 = expf(x[0] - m_new), e1 = expf(x[1] - m_new);
          const float corr = expf(m_prev - m_new);
          const float sum = tile::warp_sum(e0 + e1);
          const float dsum = tile::warp_sum(e0 * dp[0] + e1 * dp[1]);
          if (lane == 0) {
            norm_s[r] = corr * norm_s[r] + sum;
            delta_s[r] = corr * delta_s[r] + dsum;
            lse_s[r] = m_new;
          }
        }
      }
    }
    __syncthreads();
    if (tid < kB) {
      const float l = norm_s[tid];
      if (l > 0.f) {
        delta_s[tid] /= l;
      } else {                             // a row past the end: p = 0
        lse_s[tid] = INFINITY;
        norm_s[tid] = 1.f;
        delta_s[tid] = 0.f;
      }
      if (tid < qr) {
        const size_t at = ((size_t)b * g.nh + h) * g.sq + q0 + tid;
        st.lse[at] = lse_s[tid];
        st.norm[at] = norm_s[tid];
        st.delta[at] = delta_s[tid];
      }
    }
  } else {
    stage_stats<kNorm>(lse_s, norm_s, delta_s, st, b, h, q0, qr, g);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB, kr = min(kB, g.sk - k0);
    __syncthreads();
    stage_keys(k0, kr);
    __syncthreads();
    // S = Q K^T, dP = dO V^T
    tile::mma<T, false, true>(s_s, ps, q_s, pd, k_s, pd, kB, kB, d, false);
    tile::mma<T, false, true>(dp_s, ps, do_s, pd, v_s, pd, kB, kB, d, false);
    __syncthreads();
    for (int idx = tid; idx < kB * kB; idx += kThreads) {
      const int r = idx / kB, j = idx - r * kB;
      const float p = prob<kNorm>(g, s_s[r * ps + j], lse_s[r],
                                  kNorm ? norm_s[r] : 1.f, q0 + r, k0 + j,
                                  segq[r], segk[j]);
      ds_s[r * pp + j] =
          from_f<T>(p * (dp_s[r * ps + j] - delta_s[r]) * g.scale);
    }
    __syncthreads();
    // dQ += dS K
    tile::mma<T, false, false>(dq_s, po, ds_s, pp, k_s, pd, kB, d, kB, true);
  }
  __syncthreads();
  for (int idx = tid; idx < qr * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    dq[(((size_t)b * g.sq + q0 + r) * g.nh + h) * d + c] =
        from_f<T>(dq_s[r * po + c]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

inline bool geometry_ok(int b, const Geometry& g, bool with_seg) {
  return b > 0 && b <= 65535 && g.sq > 0 && g.sk > 0 && g.nh > 0 &&
         g.nh <= 65535 && g.kvh > 0 && g.kvh <= 65535 && g.nh % g.kvh == 0 &&
         g.d > 0 && g.d <= kMaxHeadDim && g.d % 16 == 0 &&
         (!g.causal || g.sq == g.sk) && (!with_seg || g.sk <= g.sq);
}

template <typename T>
using FwdKernel = void (*)(const T*, const T*, const T*, T*, float*,
                           const int*, View, View, View, Geometry);
template <typename T>
using DeltaKernel = void (*)(const T*, const T*, float*, long long, int, int,
                             int);
template <typename T>
using DkdvKernel = void (*)(const T*, const T*, const T*, const T*, Stats,
                            const int*, T*, T*, View, View, View, Geometry);
template <typename T>
using DqKernel = void (*)(const T*, const T*, const T*, const T*, Stats,
                          const int*, T*, View, View, View, Geometry);

// The online-softmax forward: one block per (64 rows, head, batch).
template <typename T>
cudaError_t launch_fwd(FwdKernel<T> kernel, const void* q, const void* k,
                       const void* v, void* out, float* lse, const int* seg,
                       View qv, View kv, View vv, int b, const Geometry& g,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem<T>(g.d);
  cudaError_t err = tile::prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.sq + kB - 1) / kB, g.nh, b);
  kernel<<<grid, kThreads, smem, stream>>>((const T*)q, (const T*)k,
                                           (const T*)v, (T*)out, lse, seg, qv,
                                           kv, vv, g);
  return cudaGetLastError();
}

// The backward from the forward's lse: delta, then dK/dV, then dQ.
template <typename T>
cudaError_t launch_bwd(DeltaKernel<T> delta_kernel, DkdvKernel<T> dkdv_kernel,
                       DqKernel<T> dq_kernel, const void* q, const void* k,
                       const void* v, const void* out, const void* dout,
                       float* lse, const int* seg, float* delta, void* dq,
                       void* dk, void* dv, View qv, View kv, View vv, int b,
                       const Geometry& g, cudaStream_t stream) {
  const size_t smem_kv = bwd_smem<T>(g.d, 2), smem_q = bwd_smem<T>(g.d, 1);
  cudaError_t err = tile::prepare(dkdv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  err = tile::prepare(dq_kernel, smem_q);
  if (err != cudaSuccess) return err;
  const long long n_rows = (long long)b * g.sq * g.nh;
  const int rows_per_block = kThreads / 32;
  delta_kernel<<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block),
                 kThreads, 0, stream>>>((const T*)out, (const T*)dout, delta,
                                        n_rows, g.sq, g.nh, g.d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Stats st{lse, nullptr, delta};
  const dim3 grid_kv((g.sk + kB - 1) / kB, g.kvh, b);
  dkdv_kernel<<<grid_kv, kThreads, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, st, seg, (T*)dk,
      (T*)dv, qv, kv, vv, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((g.sq + kB - 1) / kB, g.nh, b);
  dq_kernel<<<grid_q, kThreads, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, st, seg, (T*)dq,
      qv, kv, vv, g);
  return cudaGetLastError();
}

}  // namespace attn
