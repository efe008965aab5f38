// Flash attention for Hopper (sm_90a): causal or plain softmax attention
// with q, k and v of one head count, forward and backward, on both paths of
// the reference.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   #5 flash_single_fwd_kernel     <- _fwd_single_kernel (seq <= 1024)
//   #6 flash_single_dq_kernel,
//      flash_single_dkdv_kernel    <- _bwd_single_kernel
//   #7 flash_fwd_kernel            <- _fwd_kernel (the tiled path)
//   #8 flash_delta_kernel,
//      flash_dkdv_kernel,
//      flash_dq_kernel             <- _bwd_fused_kernel
// The plain PyTorch versions in ops/kernels/flash_attention.py
// (flash_attention_single_ref / flash_attention_single_bwd_ref,
// flash_attention_ref / flash_attention_bwd_ref) define the contract; these
// kernels follow their arithmetic and their bf16 cast points.
//
// Layouts, masking and the tile machinery: attention_tiles.cuh. q, k, v
// [b, s, nh, d] are strided views (unit stride along d), out, dout, dq, dk,
// dv contiguous, lse [b, nh, sq] fp32.
//
// #7 and #8 are the splash kernels' bodies (csrc/splash_attention.cu) with
// kvh = nh and no segment ids: the tiled online softmax casts the
// unnormalised P to the value dtype and divides O by l at the end, and
// returns lse = m + log l; the backward takes lse and out from outside
// (under ring attention they are the global ones, so p = exp(s - lse) sums
// to less than 1 over one key block, and nothing renormalises), computes
// delta = rowsum(dO * O) in fp32 from the given out, and sums dK, dV and dQ
// in fp32, cast once.
//
// #5 keeps the single-block kernel's numerics although a 1024 x 1024 fp32
// score row does not fit a block (227 KB): one block per (64 query rows,
// head, batch) walks the key tiles twice, first for the row max m and sum
// l (online, fp32), then for P = exp(s - m) / l, normalised *before* its
// cast to the value dtype as in the TPU kernel, and O += P V. There is no
// lse. #6 recomputes that softmax from q, k, v alone: the dQ kernel first
// walks the key tiles for m, l and delta = sum_j p_j dP_j (the TPU kernel's
// delta, not rowsum(dO * O), which differs once P is rounded), writes them
// to a [3, b, nh, sq] fp32 scratch, then walks them again for dQ; the dK/dV
// kernel, launched after it, reads the scratch. Neither kernel uses float
// atomics: every sum lives in one block in a fixed order, so gradients are
// bit-reproducible, and the [s, s] matrix never reaches device memory.
//
// What bounds them on the H100 (bytes over 3.35 TB/s or operations over
// 989 TFLOP/s, the larger; causal bf16, d 64): #5 at [8, 1024, 32, 64]
// moves q, k, v, out (134 MB, 0.040 ms) for two products over the causal
// pairs (3.4e10 flops, 0.035 ms); #6 does five products (8.6e10 flops,
// 0.087 ms); #7 at [4, 2048, 32, 64] does 6.9e10 flops (0.069 ms) and #8
// 1.7e11 (0.174 ms). What these simple kernels leave on the table is
// splash's list (wmma from shared memory, no cp.async/TMA pipelining, 4-warp
// blocks) plus the single-block path's extra work: #5 computes S twice (3
// products where the bound counts 2) and #6 computes S and dP three times
// (9 products where the bound counts 5).

#include "attention_tiles.cuh"

namespace {

using attn::Geometry;
using attn::kB;
using attn::kThreads;
using attn::View;
using tile::from_f;

// ---------------------------------------------------------------------------
// #5: the single-block forward, exact softmax in two passes
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_single_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, View qv, View kv, View vv, Geometry g) {
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kB, rows = min(kB, g.sq - q0);
  const int d = g.d;
  const int pd = tile::pitch<T>(d), pp = tile::pitch<T>(kB);
  const int ps = kB + 4, po = d + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(128) unsigned char smem[];
  attn::FwdTiles<T> t(smem, d);

  tile::stage(t.q, pd, q + b * qv.b + q0 * qv.s + h * qv.h, qv.s, kB, rows,
              d);
  for (int idx = tid; idx < kB * d; idx += kThreads)
    t.o[(idx / d) * po + idx % d] = 0.f;
  if (tid < kB) {
    t.m[tid] = -INFINITY;
    t.l[tid] = 0.f;
  }
  const int n_kt = attn::key_tiles(g, q0, rows);

  // pass 1: the row max m and the row sum l of exp(s - m), online in fp32
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB, kr = min(kB, g.sk - k0);
    __syncthreads();   // the last tile's S has been read
    tile::stage(t.k, pd, k + b * kv.b + k0 * kv.s + h * kv.h, kv.s, kB, kr,
                d);
    __syncthreads();
    tile::mma<T, false, true>(t.s, ps, t.q, pd, t.k, pd, kB, kB, d, false);
    __syncthreads();
    for (int r = warp; r < kB; r += kThreads / 32) {
      const int i = q0 + r;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        x[e] = attn::visible(g, i, k0 + j, 0, 0) ? t.s[r * ps + j] * g.scale
                                                 : -INFINITY;
      }
      const float m_prev = t.m[r];
      const float m_new = fmaxf(m_prev, tile::warp_max(fmaxf(x[0], x[1])));
      if (m_new != -INFINITY) {            // uniform over the warp
        const float sum =
            tile::warp_sum(expf(x[0] - m_new) + expf(x[1] - m_new));
        if (lane == 0) {
          t.l[r] = expf(m_prev - m_new) * t.l[r] + sum;
          t.m[r] = m_new;
        }
      }
    }
  }

  // pass 2: P = exp(s - m) / l in the value dtype, O += P V
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB, kr = min(kB, g.sk - k0);
    __syncthreads();   // pass 1's stats are final; the last P.V is done
    tile::stage(t.k, pd, k + b * kv.b + k0 * kv.s + h * kv.h, kv.s, kB, kr,
                d);
    tile::stage(t.v, pd, v + b * vv.b + k0 * vv.s + h * vv.h, vv.s, kB, kr,
                d);
    __syncthreads();
    tile::mma<T, false, true>(t.s, ps, t.q, pd, t.k, pd, kB, kB, d, false);
    __syncthreads();
    for (int idx = tid; idx < kB * kB; idx += kThreads) {
      const int r = idx / kB, j = idx - r * kB;
      const float p = attn::visible(g, q0 + r, k0 + j, 0, 0)
                          ? expf(t.s[r * ps + j] * g.scale - t.m[r]) / t.l[r]
                          : 0.f;
      t.p[r * pp + j] = from_f<T>(p);
    }
    __syncthreads();
    tile::mma<T, false, false>(t.o, po, t.p, pp, t.v, pd, kB, d, kB, true);
  }
  __syncthreads();
  for (int idx = tid; idx < rows * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    out[(((size_t)b * g.sq + q0 + r) * g.nh + h) * d + c] =
        from_f<T>(t.o[r * po + c]);
  }
}

// ---------------------------------------------------------------------------
// #6: the single-block backward (softmax recomputed from q, k, v)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_single_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, attn::Stats st, T* __restrict__ dq, View qv,
    View kv, View vv, Geometry g) {
  attn::dq_body<T, true, true>(q, k, v, dout, st, nullptr, dq, qv, kv, vv, g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_single_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, attn::Stats st, T* __restrict__ dk,
    T* __restrict__ dv, View qv, View kv, View vv, Geometry g) {
  attn::dkdv_body<T, true>(q, k, v, dout, st, nullptr, dk, dv, qv, kv, vv, g);
}

// ---------------------------------------------------------------------------
// #7 / #8: the tiled path (the splash bodies, kvh = nh, no segments)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, const int* __restrict__ seg,
    View qv, View kv, View vv, Geometry g) {
  attn::fwd_body<T>(q, k, v, out, lse, seg, qv, kv, vv, g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ delta, long long n_rows, int sq, int nh, int d) {
  attn::delta_body<T>(out, dout, delta, n_rows, sq, nh, d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, attn::Stats st, const int* __restrict__ seg,
    T* __restrict__ dk, T* __restrict__ dv, View qv, View kv, View vv,
    Geometry g) {
  attn::dkdv_body<T, false>(q, k, v, dout, st, seg, dk, dv, qv, kv, vv, g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, attn::Stats st, const int* __restrict__ seg,
    T* __restrict__ dq, View qv, View kv, View vv, Geometry g) {
  attn::dq_body<T, false, false>(q, k, v, dout, st, seg, dq, qv, kv, vv, g);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t fwd_single(const void* q, const void* k, const void* v,
                       void* out, View qv, View kv, View vv, int b,
                       const Geometry& g, cudaStream_t stream) {
  const size_t smem = attn::fwd_smem<T>(g.d);
  cudaError_t err = tile::prepare(flash_single_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.sq + kB - 1) / kB, g.nh, b);
  flash_single_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, qv, kv, vv, g);
  return cudaGetLastError();
}

// dQ first (it writes the row stats), then dK/dV (which read them).
template <typename T>
cudaError_t bwd_single(const void* q, const void* k, const void* v,
                       const void* dout, float* stats, void* dq, void* dk,
                       void* dv, View qv, View kv, View vv, int b,
                       const Geometry& g, cudaStream_t stream) {
  const size_t smem_q = attn::bwd_smem<T>(g.d, 1, 3);
  const size_t smem_kv = attn::bwd_smem<T>(g.d, 2, 3);
  cudaError_t err = tile::prepare(flash_single_dq_kernel<T>, smem_q);
  if (err != cudaSuccess) return err;
  err = tile::prepare(flash_single_dkdv_kernel<T>, smem_kv);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)b * g.nh * g.sq;
  const attn::Stats st{stats, stats + n, stats + 2 * n};
  const dim3 grid_q((g.sq + kB - 1) / kB, g.nh, b);
  flash_single_dq_kernel<T><<<grid_q, kThreads, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, st, (T*)dq, qv,
      kv, vv, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((g.sk + kB - 1) / kB, g.nh, b);
  flash_single_dkdv_kernel<T><<<grid_kv, kThreads, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, st, (T*)dk,
      (T*)dv, qv, kv, vv, g);
  return cudaGetLastError();
}

Geometry geometry(int sq, int sk, int nh, int d, int causal, float scale) {
  return Geometry{sq, sk, nh, nh, d, causal, scale};
}

}  // namespace

// Plain C interface for ctypes: strides (qb, qs, qh, ...) are element
// strides of the q, k, v views over batch, row and head. Each returns the
// cudaError_t of its launches (cudaErrorInvalidValue for a geometry or a
// shared-memory size the kernels do not take); nothing is allocated and
// nothing synchronises.
extern "C" int flash_fwd_single(const void* q, const void* k, const void* v,
                                void* out, long long qb, long long qs,
                                long long qh, long long kb, long long ks,
                                long long kh, long long vb, long long vs,
                                long long vh, int b, int sq, int sk, int nh,
                                int d, int causal, float scale, int bf16,
                                void* stream) {
  const Geometry g = geometry(sq, sk, nh, d, causal, scale);
  if (!attn::geometry_ok(b, g, false)) return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)fwd_single<__nv_bfloat16>(q, k, v, out, qv, kv, vv, b, g, s);
  return (int)fwd_single<float>(q, k, v, out, qv, kv, vv, b, g, s);
}

// stats: [3, b, nh, sq] fp32 scratch (row max, row sum, delta).
extern "C" int flash_bwd_single(const void* q, const void* k, const void* v,
                                const void* dout, void* stats, void* dq,
                                void* dk, void* dv, long long qb,
                                long long qs, long long qh, long long kb,
                                long long ks, long long kh, long long vb,
                                long long vs, long long vh, int b, int sq,
                                int sk, int nh, int d, int causal,
                                float scale, int bf16, void* stream) {
  const Geometry g = geometry(sq, sk, nh, d, causal, scale);
  if (!attn::geometry_ok(b, g, false)) return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)bwd_single<__nv_bfloat16>(q, k, v, dout, (float*)stats, dq,
                                          dk, dv, qv, kv, vv, b, g, s);
  return (int)bwd_single<float>(q, k, v, dout, (float*)stats, dq, dk, dv, qv,
                                kv, vv, b, g, s);
}

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, long long qb, long long qs,
                         long long qh, long long kb, long long ks,
                         long long kh, long long vb, long long vs,
                         long long vh, int b, int sq, int sk, int nh, int d,
                         int causal, float scale, int bf16, void* stream) {
  const Geometry g = geometry(sq, sk, nh, d, causal, scale);
  if (!attn::geometry_ok(b, g, false)) return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)attn::launch_fwd<__nv_bfloat16>(
        flash_fwd_kernel<__nv_bfloat16>, q, k, v, out, (float*)lse, nullptr,
        qv, kv, vv, b, g, s);
  return (int)attn::launch_fwd<float>(flash_fwd_kernel<float>, q, k, v, out,
                                      (float*)lse, nullptr, qv, kv, vv, b, g,
                                      s);
}

// lse and out from outside (the forward's, or a ring's global ones); delta:
// [b, nh, sq] fp32 scratch.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv,
                         long long qb, long long qs, long long qh,
                         long long kb, long long ks, long long kh,
                         long long vb, long long vs, long long vh, int b,
                         int sq, int sk, int nh, int d, int causal,
                         float scale, int bf16, void* stream) {
  const Geometry g = geometry(sq, sk, nh, d, causal, scale);
  if (!attn::geometry_ok(b, g, false)) return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  float* l = const_cast<float*>((const float*)lse);
  if (bf16)
    return (int)attn::launch_bwd<__nv_bfloat16>(
        flash_delta_kernel<__nv_bfloat16>, flash_dkdv_kernel<__nv_bfloat16>,
        flash_dq_kernel<__nv_bfloat16>, q, k, v, out, dout, l, nullptr,
        (float*)delta, dq, dk, dv, qv, kv, vv, b, g, s);
  return (int)attn::launch_bwd<float>(
      flash_delta_kernel<float>, flash_dkdv_kernel<float>,
      flash_dq_kernel<float>, q, k, v, out, dout, l, nullptr, (float*)delta,
      dq, dk, dv, qv, kv, vv, b, g, s);
}
