// Splash training attention for Hopper (sm_90a): causal or plain softmax
// attention with GQA and packed-sequence segment ids, forward and backward.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/splash_attention.py:
//   splash_fwd_wgmma_kernel (bf16),
//   splash_fwd_kernel (fp32)   <- _fwd_kernel (via _fwd, one pallas_call)
//   splash_delta_kernel, then
//   splash_dq_wgmma_kernel,
//   splash_dkdv_wgmma_kernel (bf16),
//   splash_dkdv_kernel,
//   splash_dq_kernel (fp32)    <- _bwd_kernel (via _bwd_call)
// The plain PyTorch versions (splash_attention_ref / splash_attention_bwd_ref
// in ops/kernels/splash_attention.py) define the contract and these kernels
// follow their arithmetic: fp32 scores, fp32 online softmax, P cast to the
// value dtype before P.V with fp32 accumulation, output in q's dtype; the
// backward recomputes p = exp(s * scale - lse) and casts dS to q's dtype
// before its two products, with fp32 dQ/dK/dV accumulators cast at the end.
// delta = rowsum(dO * O) in fp32 is a kernel of its own in both routes
// (splash_delta_kernel, attention_tiles.cuh's `delta_body`).
//
// Layouts, masking and design: the bf16 forward is attention_wgmma.cuh's
// warpgroup body and the bf16 backward attention_wgmma_bwd.cuh's dQ and
// dK/dV bodies, with GQA (a dK/dV item walks every query head of its kv
// head's group, so each dK/dV sum stays one warpgroup's) and segment ids
// (the producers write each tile's ids beside it); their notes give the
// design and what it leaves on the table. The fp32 forward and backward
// are attention_tiles.cuh's bodies. flash_attention.cu wraps the same
// bodies, without segment ids and GQA, for TPU kernels #5-#8.
//
// What bounds it on the H100: at the training shape (b 8, s 1024, 32 heads,
// d 64, causal) the forward moves q, k, v, o (134 MB, 0.040 ms at
// 3.35 TB/s) for 3.4e10 flops (0.035 ms at 989 TFLOP/s), and the backward
// does 8.6e10 flops of products (0.087 ms). The bf16 kernels keep the
// tiles in flight by TMA and every score tile in registers.
// What the fp32 routes leave on the table: CUDA cores from shared memory
// instead of wgmma, no cp.async/TMA pipelining (a tile's loads and math
// do not overlap), products staged through fp32 shared memory between
// the softmax steps, and a second recompute of S and P in the backward.

#include "attention_wgmma_bwd.cuh"

namespace {

using attn::Geometry;
using attn::View;
using attn::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads) splash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, const int* __restrict__ seg,
    View qv, View kv, View vv, Geometry g) {
  attn::fwd_body<T>(q, k, v, out, lse, seg, qv, kv, vv, g);
}

// bf16: attention_wgmma.cuh's body. D: the head dim padded to 64 or 128;
// kSeg: segment ids given.
template <int D, bool kSeg>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    splash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse,
                            const int* __restrict__ seg, Geometry g,
                            int batch) {
  attn_wg::fwd_body<D, kSeg>(tq, tk, tv, out, lse, seg, g, batch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) splash_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ delta, long long n_rows, int sq, int nh, int d) {
  attn::delta_body<T>(out, dout, delta, n_rows, sq, nh, d);
}

// bf16: attention_wgmma_bwd.cuh's bodies from the forward's lse and the
// delta of splash_delta_kernel, with GQA (a dK/dV item walks its kv
// head's group of query heads) and, with kSeg, segment ids. D: the head
// dim padded to 64 or 128.
template <int D, bool kSeg>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    splash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           attn::Stats st, const int* __restrict__ seg,
                           __nv_bfloat16* __restrict__ dq, Geometry g,
                           int batch) {
  attn_wg::dq_body<D, false, kSeg>(tq, tk, tv, tdo, st, seg, dq, g, batch);
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    splash_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             attn::Stats st, const int* __restrict__ seg,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, Geometry g,
                             int batch) {
  attn_wg::dkdv_body<D, false, kSeg>(tq, tk, tv, tdo, st, seg, dk, dv, g,
                                     batch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) splash_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, attn::Stats st, const int* __restrict__ seg,
    T* __restrict__ dk, T* __restrict__ dv, View qv, View kv, View vv,
    Geometry g) {
  attn::dkdv_body<T, false>(q, k, v, dout, st, seg, dk, dv, qv, kv, vv, g);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) splash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, attn::Stats st, const int* __restrict__ seg,
    T* __restrict__ dq, View qv, View kv, View vv, Geometry g) {
  attn::dq_body<T, false, false>(q, k, v, dout, st, seg, dq, qv, kv, vv, g);
}

cudaError_t fwd_fp32(const void* q, const void* k, const void* v, void* out,
                     float* lse, const int* seg, View qv, View kv, View vv,
                     int b, const Geometry& g, cudaStream_t stream) {
  return attn::launch_fwd<float>(splash_fwd_kernel<float>, q, k, v, out, lse,
                                 seg, qv, kv, vv, b, g, stream);
}

template <int D, bool kSeg>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out,
                     float* lse, const int* seg, View qv, View kv, View vv,
                     int b, const Geometry& g, cudaStream_t stream) {
  return attn_wg::launch_fwd<D, kSeg>(splash_fwd_wgmma_kernel<D, kSeg>, q, k,
                                      v, out, lse, seg, qv, kv, vv, b, g,
                                      stream);
}

// bf16: delta = rowsum(dO * O) (splash_delta_kernel), then the wgmma dQ
// and dK/dV kernels of <D, kSeg>.
template <int D, bool kSeg>
cudaError_t bwd_bf16(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, float* lse,
                     const int* seg, float* delta, void* dq, void* dk,
                     void* dv, View qv, View kv, View vv, int b,
                     const Geometry& g, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const long long n_rows = (long long)b * g.sq * g.nh;
  const int rows_per_block = kThreads / 32;
  splash_delta_kernel<T>
      <<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block),
         kThreads, 0, stream>>>((const T*)out, (const T*)dout, delta, n_rows,
                                g.sq, g.nh, g.d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const attn::Stats st{lse, nullptr, delta};
  return attn_wg::launch_bwd<D, kSeg>(
      splash_dq_wgmma_kernel<D, kSeg>, splash_dkdv_wgmma_kernel<D, kSeg>, q,
      k, v, dout, st, seg, dq, dk, dv, qv, kv, vv, b, g, stream);
}

template <typename T>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, const int* seg,
                float* delta, void* dq, void* dk, void* dv, View qv, View kv,
                View vv, int b, const Geometry& g, cudaStream_t stream) {
  return attn::launch_bwd<T>(splash_delta_kernel<T>, splash_dkdv_kernel<T>,
                             splash_dq_kernel<T>, q, k, v, out, dout,
                             const_cast<float*>(lse), seg, delta, dq, dk, dv,
                             qv, kv, vv, b, g, stream);
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
  if (!attn::geometry_ok(b, g, seg != nullptr))
    return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  const int* ids = (const int*)seg;
  float* l = (float*)lse;
  if (!bf16)
    return (int)fwd_fp32(q, k, v, out, l, ids, qv, kv, vv, b, g, s);
  if (ids)
    return (int)(d <= 64 ? fwd_bf16<64, true>(q, k, v, out, l, ids, qv, kv,
                                              vv, b, g, s)
                         : fwd_bf16<128, true>(q, k, v, out, l, ids, qv, kv,
                                               vv, b, g, s));
  return (int)(d <= 64 ? fwd_bf16<64, false>(q, k, v, out, l, ids, qv, kv,
                                             vv, b, g, s)
                       : fwd_bf16<128, false>(q, k, v, out, l, ids, qv, kv,
                                              vv, b, g, s));
}

// The dynamic shared memory a bf16 forward block launches with at head dim
// d, with (seg != 0) or without segment ids.
extern "C" int splash_fwd_bf16_smem(int d, int seg) {
  if (seg)
    return (int)(d <= 64 ? attn_wg::FwdSmem<64, true>::kBytes
                         : attn_wg::FwdSmem<128, true>::kBytes);
  return (int)(d <= 64 ? attn_wg::FwdSmem<64, false>::kBytes
                       : attn_wg::FwdSmem<128, false>::kBytes);
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
  if (!attn::geometry_ok(b, g, seg != nullptr))
    return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)const_cast<void*>(lse);
  const int* ids = (const int*)seg;
  float* dl = (float*)delta;
  if (bf16) {
    if (ids)
      return (int)(d <= 64 ? bwd_bf16<64, true>(q, k, v, out, dout, l, ids,
                                                dl, dq, dk, dv, qv, kv, vv,
                                                b, g, s)
                           : bwd_bf16<128, true>(q, k, v, out, dout, l, ids,
                                                 dl, dq, dk, dv, qv, kv, vv,
                                                 b, g, s));
    return (int)(d <= 64 ? bwd_bf16<64, false>(q, k, v, out, dout, l, ids,
                                               dl, dq, dk, dv, qv, kv, vv, b,
                                               g, s)
                         : bwd_bf16<128, false>(q, k, v, out, dout, l, ids,
                                                dl, dq, dk, dv, qv, kv, vv, b,
                                                g, s));
  }
  return (int)bwd<float>(q, k, v, out, dout, (const float*)lse,
                         (const int*)seg, (float*)delta, dq, dk, dv, qv, kv,
                         vv, b, g, s);
}

// The dynamic shared memory the bf16 backward's dQ (which = 0) or dK/dV
// (which = 1) blocks launch with at head dim d, with (seg != 0) or
// without segment ids.
extern "C" int splash_bwd_bf16_smem(int d, int seg, int which) {
  using namespace attn_wg;
  if (which)
    return (int)(seg ? (d <= 64 ? DkdvSmem<64, true>::kBytes
                                : DkdvSmem<128, true>::kBytes)
                     : (d <= 64 ? DkdvSmem<64, false>::kBytes
                                : DkdvSmem<128, false>::kBytes));
  return (int)(seg ? (d <= 64 ? DqSmem<64, true>::kBytes
                              : DqSmem<128, true>::kBytes)
                   : (d <= 64 ? DqSmem<64, false>::kBytes
                              : DqSmem<128, false>::kBytes));
}
