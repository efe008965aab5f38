// Splash training attention for Hopper (sm_90a): causal or plain softmax
// attention with GQA and packed-sequence segment ids, forward and backward.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/splash_attention.py:
//   splash_fwd_kernel          <- _fwd_kernel (via _fwd, one pallas_call)
//   splash_delta_kernel,
//   splash_dkdv_kernel,
//   splash_dq_kernel           <- _bwd_kernel (via _bwd_call)
// The plain PyTorch versions (splash_attention_ref / splash_attention_bwd_ref
// in ops/kernels/splash_attention.py) define the contract and these kernels
// follow their arithmetic: fp32 scores, fp32 online softmax, P cast to the
// value dtype before P.V with fp32 accumulation, output in q's dtype; the
// backward recomputes p = exp(s * scale - lse) and casts dS to q's dtype
// before its two products, with fp32 dQ/dK/dV accumulators cast at the end.
//
// Layouts: q [b, sq, nh, d], k/v [b, sk, kvh, d] as strided views (any
// batch, row and head strides, unit stride along d: the wrapper passes
// qkv.reshape(b, s, 3, nh, d)[:, :, i] without a copy); segment ids
// [b, sq] int32 (keys use the same table: seg[:, :sk]); out, dq [b, sq, nh,
// d], dk, dv [b, sk, kvh, d] and dout contiguous; lse and delta [b, nh, sq]
// fp32. Head h reads kv head h / (nh / kvh). Key j is visible to row i when
// j < sk, (not causal or j <= i) and seg[i] == seg[j]; the [s, s] mask never
// exists. A row with no visible key gets output 0, lse = +inf and zero
// gradients (exp(s - inf) = 0 exactly).
//
// Design: 128 threads a block, 64-row tiles staged in shared memory, the
// products in tile_mma.cuh (wmma on the tensor cores in bf16, CUDA cores in
// fp32).
//   forward: one block per (64 query rows, head, batch); it walks the key
//     tiles in order with an online softmax (m, l, O in shared memory) and
//     skips key tiles wholly above the diagonal. A tile that is fully
//     masked (segments) leaves the running stats as they were.
//   backward: delta = rowsum(dO * O) first; then one block per (64 keys, kv
//     head, batch) walks the group's query heads and the query tiles at or
//     below the diagonal, accumulating dK and dV in shared memory; and one
//     block per (64 query rows, head, batch) walks the key tiles,
//     accumulating dQ. Every sum lives inside one block and runs in a fixed
//     order: no atomics, so the gradients are bit-reproducible. The price
//     is that S and P are recomputed in both kernels.
//
// What bounds it on the H100: at the training shape (b 8, s 1024, 32 heads,
// d 64, causal) the forward moves q, k, v, o (134 MB, 0.040 ms at
// 3.35 TB/s) for 3.4e10 flops (0.035 ms at 989 TFLOP/s), and the backward
// does 8.6e10 flops of products (0.087 ms). What this simple design leaves
// on the table: wmma from shared memory instead of wgmma, no cp.async/TMA
// pipelining (a tile's loads and math do not overlap), products staged
// through fp32 shared memory between the softmax steps, one warp per 16
// rows for the softmax, and a second recompute of S and P in the backward.

#include "tile_mma.cuh"

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kThreads) splash_fwd_kernel(
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
  size_t off = 0;
  T* q_s = (T*)(smem + tile::take(off, 3 * kB * pd * sizeof(T)));
  T* k_s = q_s + kB * pd;
  T* v_s = k_s + kB * pd;
  float* s_s = (float*)(smem + tile::take(off, kB * ps * sizeof(float)));
  T* p_s = (T*)(smem + tile::take(off, kB * pp * sizeof(T)));
  float* o_s = (float*)(smem + tile::take(off, kB * po * sizeof(float)));
  float* m_s = (float*)(smem + tile::take(off, 3 * kB * sizeof(float)));
  float* l_s = m_s + kB;
  float* c_s = l_s + kB;
  int* segq = (int*)(smem + tile::take(off, 2 * kB * sizeof(int)));
  int* segk = segq + kB;

  tile::stage(q_s, pd, q + b * qv.b + q0 * qv.s + h * qv.h, qv.s, kB, rows,
              d);
  for (int idx = tid; idx < kB * d; idx += kThreads)
    o_s[(idx / d) * po + idx % d] = 0.f;
  if (tid < kB) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  stage_seg(segq, seg, b, g.sq, q0, g.sq, -1);
  const int nk = (g.sk + kB - 1) / kB;
  const int n_kt = g.causal ? min(nk, (q0 + rows - 1) / kB + 1) : nk;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB, kr = min(kB, g.sk - k0);
    __syncthreads();   // the last tile's P.V has read K, V, P
    tile::stage(k_s, pd, k + b * kv.b + k0 * kv.s + kh * kv.h, kv.s, kB, kr,
                d);
    tile::stage(v_s, pd, v + b * vv.b + k0 * vv.s + kh * vv.h, vv.s, kB, kr,
                d);
    stage_seg(segk, seg, b, g.sq, k0, g.sk, -2);
    __syncthreads();
    tile::mma<T, false, true>(s_s, ps, q_s, pd, k_s, pd, kB, kB, d, false);
    __syncthreads();

    // online softmax: one warp per row, two keys per lane
    for (int r = warp; r < kB; r += kThreads / 32) {
      const int i = q0 + r;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        x[e] = visible(g, i, k0 + j, segq[r], segk[j])
                   ? s_s[r * ps + j] * g.scale
                   : -INFINITY;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, tile::warp_max(fmaxf(x[0], x[1])));
      float p0 = 0.f, p1 = 0.f, corr = 1.f;
      // a fully masked tile keeps the empty state: no exp(-inf - -inf)
      if (m_new != -INFINITY) {
        p0 = expf(x[0] - m_new);
        p1 = expf(x[1] - m_new);
        corr = expf(m_prev - m_new);
      }
      p_s[r * pp + lane] = from_f<T>(p0);
      p_s[r * pp + lane + 32] = from_f<T>(p1);
      const float sum = tile::warp_sum(p0 + p1);
      if (lane == 0) {
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < kB * d; idx += kThreads) {
      const int r = idx / d;
      o_s[r * po + idx - r * d] *= c_s[r];
    }
    __syncthreads();
    tile::mma<T, false, false>(o_s, po, p_s, pp, v_s, pd, kB, d, kB, true);
  }
  __syncthreads();

  for (int idx = tid; idx < rows * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const float l = l_s[r];
    out[(((size_t)b * g.sq + q0 + r) * g.nh + h) * d + c] =
        from_f<T>(o_s[r * po + c] / (l == 0.f ? 1.f : l));
  }
  if (tid < rows) {
    const float l = l_s[tid];
    lse[((size_t)b * g.nh + h) * g.sq + q0 + tid] =
        l > 0.f ? m_s[tid] + logf(l) : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// delta[b, h, i] = sum_d dO * O in fp32: one warp per (b, i, h) row.
template <typename T>
__global__ void __launch_bounds__(kThreads) splash_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ delta, long long n_rows, int sq, int nh, int d) {
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
// lse, delta and the segment ids. The accumulators go unpadded (only the
// products and the final copy-out touch them): at d = 64 in bf16 that
// brings the dK/dV kernel to 112 KB, so two of its blocks fit an SM.
template <typename T>
size_t bwd_smem(int d, int n_acc) {
  const int pd = tile::pitch<T>(d), pp = tile::pitch<T>(kB);
  size_t off = 0;
  tile::take(off, 4 * kB * pd * sizeof(T));
  tile::take(off, 2 * kB * (kB + 4) * sizeof(float));
  tile::take(off, kB * pp * sizeof(T));
  tile::take(off, n_acc * kB * d * sizeof(float));
  tile::take(off, 2 * kB * sizeof(float));
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

// p = exp(s * scale - lse) where visible, else 0 (S in s_s, fp32).
__device__ __forceinline__ float prob(const Geometry& g, float s, float lse_r,
                                      int i, int j, int seg_i, int seg_j) {
  return visible(g, i, j, seg_i, seg_j) ? expf(s * g.scale - lse_r) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) splash_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg,
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
  float* lse_s = sm.take<float>(2 * kB);
  float* delta_s = lse_s + kB;
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
      if (tid < kB) {
        const bool in = tid < qr;
        const size_t at = ((size_t)b * g.nh + h) * g.sq + q0 + tid;
        lse_s[tid] = in ? lse[at] : INFINITY;
        delta_s[tid] = in ? delta[at] : 0.f;
      }
      stage_seg(segq, seg, b, g.sq, q0, g.sq, -1);
      __syncthreads();
      tile::mma<T, false, true>(s_s, ps, q_s, pd, k_s, pd, kB, kB, d, false);
      __syncthreads();
      for (int idx = tid; idx < kB * kB; idx += kThreads) {
        const int r = idx / kB, j = idx - r * kB;
        const float p = prob(g, s_s[r * ps + j], lse_s[r], q0 + r, k0 + j,
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

template <typename T>
__global__ void __launch_bounds__(kThreads) splash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg,
    T* __restrict__ dq, View qv, View kv, View vv, Geometry g) {
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (g.nh / g.kvh);
  const int q0 = qt * kB, qr = min(kB, g.sq - q0);
  const int d = g.d;
  const int pd = tile::pitch<T>(d), pp = tile::pitch<T>(kB);
  const int ps = kB + 4, po = d;
  const int tid = threadIdx.x;
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
  float* lse_s = sm.take<float>(2 * kB);
  float* delta_s = lse_s + kB;
  int* segq = sm.take<int>(2 * kB);
  int* segk = segq + kB;

  tile::stage(q_s, pd, q + b * qv.b + q0 * qv.s + h * qv.h, qv.s, kB, qr, d);
  tile::stage(do_s, pd, dout + b * ov.b + q0 * ov.s + h * ov.h, ov.s, kB, qr,
              d);
  if (tid < kB) {
    const bool in = tid < qr;
    const size_t at = ((size_t)b * g.nh + h) * g.sq + q0 + tid;
    lse_s[tid] = in ? lse[at] : INFINITY;
    delta_s[tid] = in ? delta[at] : 0.f;
  }
  stage_seg(segq, seg, b, g.sq, q0, g.sq, -1);
  for (int idx = tid; idx < kB * po; idx += kThreads) dq_s[idx] = 0.f;
  const int nk = (g.sk + kB - 1) / kB;
  const int n_kt = g.causal ? min(nk, (q0 + qr - 1) / kB + 1) : nk;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB, kr = min(kB, g.sk - k0);
    __syncthreads();
    tile::stage(k_s, pd, k + b * kv.b + k0 * kv.s + kh * kv.h, kv.s, kB, kr,
                d);
    tile::stage(v_s, pd, v + b * vv.b + k0 * vv.s + kh * vv.h, vv.s, kB, kr,
                d);
    stage_seg(segk, seg, b, g.sq, k0, g.sk, -2);
    __syncthreads();
    // S = Q K^T, dP = dO V^T
    tile::mma<T, false, true>(s_s, ps, q_s, pd, k_s, pd, kB, kB, d, false);
    tile::mma<T, false, true>(dp_s, ps, do_s, pd, v_s, pd, kB, kB, d, false);
    __syncthreads();
    for (int idx = tid; idx < kB * kB; idx += kThreads) {
      const int r = idx / kB, j = idx - r * kB;
      const float p = prob(g, s_s[r * ps + j], lse_s[r], q0 + r, k0 + j,
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

bool geometry_ok(int b, const Geometry& g, bool with_seg) {
  return b > 0 && b <= 65535 && g.sq > 0 && g.sk > 0 && g.nh > 0 &&
         g.nh <= 65535 && g.kvh > 0 && g.kvh <= 65535 && g.nh % g.kvh == 0 &&
         g.d > 0 && g.d <= kMaxHeadDim && g.d % 16 == 0 &&
         (!g.causal || g.sq == g.sk) && (!with_seg || g.sk <= g.sq);
}

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, const int* seg, View qv, View kv, View vv, int b,
                const Geometry& g, cudaStream_t stream) {
  const size_t smem = fwd_smem<T>(g.d);
  cudaError_t err = tile::prepare(splash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.sq + kB - 1) / kB, g.nh, b);
  splash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, seg, qv, kv, vv, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, const int* seg,
                float* delta, void* dq, void* dk, void* dv, View qv, View kv,
                View vv, int b, const Geometry& g, cudaStream_t stream) {
  const size_t smem_kv = bwd_smem<T>(g.d, 2), smem_q = bwd_smem<T>(g.d, 1);
  cudaError_t err = tile::prepare(splash_dkdv_kernel<T>, smem_kv);
  if (err != cudaSuccess) return err;
  err = tile::prepare(splash_dq_kernel<T>, smem_q);
  if (err != cudaSuccess) return err;
  const long long n_rows = (long long)b * g.sq * g.nh;
  const int rows_per_block = kThreads / 32;
  splash_delta_kernel<T>
      <<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block), kThreads,
         0, stream>>>((const T*)out, (const T*)dout, delta, n_rows, g.sq,
                      g.nh, g.d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((g.sk + kB - 1) / kB, g.kvh, b);
  splash_dkdv_kernel<T><<<grid_kv, kThreads, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, seg,
      (T*)dk, (T*)dv, qv, kv, vv, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((g.sq + kB - 1) / kB, g.nh, b);
  splash_dq_kernel<T><<<grid_q, kThreads, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, seg,
      (T*)dq, qv, kv, vv, g);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Each returns the cudaError_t of its
// launches (cudaErrorInvalidValue for a geometry or a shared-memory size
// the kernels do not take); nothing is allocated and nothing synchronises.
extern "C" int splash_fwd(const void* q, const void* k, const void* v,
                          void* out, void* lse, const void* seg, long long qb,
                          long long qs, long long qh, long long kb,
                          long long ks, long long kh, long long vb,
                          long long vs, long long vh, int b, int sq, int sk,
                          int nh, int kvh, int d, int causal, float scale,
                          int bf16, void* stream) {
  const Geometry g{sq, sk, nh, kvh, d, causal, scale};
  if (!geometry_ok(b, g, seg != nullptr)) return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)fwd<__nv_bfloat16>(q, k, v, out, (float*)lse,
                                   (const int*)seg, qv, kv, vv, b, g, s);
  return (int)fwd<float>(q, k, v, out, (float*)lse, (const int*)seg, qv, kv,
                         vv, b, g, s);
}

extern "C" int splash_bwd(const void* q, const void* k, const void* v,
                          const void* out, const void* dout, const void* lse,
                          const void* seg, void* delta, void* dq, void* dk,
                          void* dv, long long qb, long long qs, long long qh,
                          long long kb, long long ks, long long kh,
                          long long vb, long long vs, long long vh, int b,
                          int sq, int sk, int nh, int kvh, int d, int causal,
                          float scale, int bf16, void* stream) {
  const Geometry g{sq, sk, nh, kvh, d, causal, scale};
  if (!geometry_ok(b, g, seg != nullptr)) return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)bwd<__nv_bfloat16>(q, k, v, out, dout, (const float*)lse,
                                   (const int*)seg, (float*)delta, dq, dk, dv,
                                   qv, kv, vv, b, g, s);
  return (int)bwd<float>(q, k, v, out, dout, (const float*)lse,
                         (const int*)seg, (float*)delta, dq, dk, dv, qv, kv,
                         vv, b, g, s);
}
