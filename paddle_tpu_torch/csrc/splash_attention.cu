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
// Layouts, masking and design: attention_tiles.cuh, whose device bodies
// these kernels wrap (flash_attention.cu wraps the same bodies, without
// segment ids and GQA, for TPU kernels #7/#8).
//
// What bounds it on the H100: at the training shape (b 8, s 1024, 32 heads,
// d 64, causal) the forward moves q, k, v, o (134 MB, 0.040 ms at
// 3.35 TB/s) for 3.4e10 flops (0.035 ms at 989 TFLOP/s), and the backward
// does 8.6e10 flops of products (0.087 ms). What this simple design leaves
// on the table: wmma from shared memory instead of wgmma, no cp.async/TMA
// pipelining (a tile's loads and math do not overlap), products staged
// through fp32 shared memory between the softmax steps, one warp per 16
// rows for the softmax, and a second recompute of S and P in the backward.

#include "attention_tiles.cuh"

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

template <typename T>
__global__ void __launch_bounds__(kThreads) splash_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ delta, long long n_rows, int sq, int nh, int d) {
  attn::delta_body<T>(out, dout, delta, n_rows, sq, nh, d);
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

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, const int* seg, View qv, View kv, View vv, int b,
                const Geometry& g, cudaStream_t stream) {
  return attn::launch_fwd<T>(splash_fwd_kernel<T>, q, k, v, out, lse, seg,
                             qv, kv, vv, b, g, stream);
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
  if (!attn::geometry_ok(b, g, seg != nullptr))
    return (int)cudaErrorInvalidValue;
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
