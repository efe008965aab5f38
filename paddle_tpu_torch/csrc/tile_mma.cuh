// Shared-memory tile products for the port's training kernels
// (splash_attention.cu, fused_cross_entropy.cu) and the weight-only
// linear's prompt-pass route (weight_only.cu).
//
// A kernel that includes this runs kNT threads (128 by default; the
// template argument of `stage` and `mma`), stages its operand tiles in
// shared memory in the storage type T (fp32, bf16 or fp16), and forms products
// into fp32 tiles with `mma`, in shared or in device memory:
//   * bf16 and fp16: tensor cores through nvcuda::wmma (16 x 16 x 16
//     fragments, fp32 accumulation), each warp a 32 x 32 block of outputs
//     (2 x 2 fragments, so every operand fragment it loads feeds two
//     products) where the tile allows, else one fragment at a time;
//   * fp32: true fp32 on the CUDA cores (never TF32), a 4 x 4 register tile
//     of outputs per thread.
// Transposed operands cost nothing: wmma reads either layout from shared
// memory, and the fp32 loop indexes either way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace tile {

constexpr int kThreads = 128;
constexpr size_t kMaxSmemBytes = 232448;   // 227 KB opt-in per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// The 16-bit storage types, which take the tensor-core branch of `mma`.
template <typename T>
constexpr bool kHalfWidth = std::is_same<T, __nv_bfloat16>::value ||
                            std::is_same<T, __half>::value;

// Row pitch (elements) of a staged tile of `cols` columns: 16 bytes of
// padding, so rows start on 16-byte boundaries, a 16-row fragment starts
// on a 32-byte one (wmma), and successive rows fall on other banks.
template <typename T>
__host__ __device__ constexpr int pitch(int cols) {
  return cols + 16 / (int)sizeof(T);
}

// Carve shared memory: the offset of the next `bytes`, 128-byte aligned.
__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off += (bytes + 127) & ~(size_t)127;
  return at;
}

// Copy a [rows x cols] tile (row r at src + r * stride, elements
// contiguous) into shared memory at pitch ld; rows at or past `valid` are
// zeros. 16-byte loads: cols is a multiple of 16 and every row starts on a
// 16-byte boundary (the wrappers check both).
template <typename T, int kNT = kThreads>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      long long stride, int rows, int valid,
                                      int cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = cols / kVec;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += kNT) {
    const int r = idx / vecs, c = (idx - r * vecs) * kVec;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      u = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
    *reinterpret_cast<uint4*>(dst + r * ld + c) = u;
  }
}

// The bf16 / fp16 branch of `mma`: each warp in turn takes an (16 F) x (16 F)
// block of C, holds its F x F accumulator fragments in registers over the
// whole K loop, and loads F fragments of A and F of B per step of 16.
template <int F, bool kATrans, bool kBTrans, int kNT, typename T>
__device__ __forceinline__ void mma_blocks(float* c, int ldc, const T* a,
                                           int lda, const T* b, int ldb,
                                           int M, int N, int K, bool acc) {
  using namespace nvcuda;
  using LA = std::conditional_t<kATrans, wmma::col_major, wmma::row_major>;
  using LB = std::conditional_t<kBTrans, wmma::col_major, wmma::row_major>;
  const int bn = N / (16 * F), nb = (M / (16 * F)) * bn;
  for (int blk = threadIdx.x >> 5; blk < nb; blk += kNT / 32) {
    const int i = (blk / bn) * 16 * F, j = (blk - (blk / bn) * bn) * 16 * F;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[F][F];
#pragma unroll
    for (int r = 0; r < F; ++r)
#pragma unroll
      for (int e = 0; e < F; ++e) {
        float* cp = c + (i + 16 * r) * ldc + j + 16 * e;
        if (acc)
          wmma::load_matrix_sync(cf[r][e], cp, ldc, wmma::mem_row_major);
        else
          wmma::fill_fragment(cf[r][e], 0.f);
      }
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> af[F];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> bf[F];
#pragma unroll
      for (int r = 0; r < F; ++r) {
        const int m = i + 16 * r;
        wmma::load_matrix_sync(af[r], kATrans ? a + k * lda + m
                                              : a + m * lda + k, lda);
      }
#pragma unroll
      for (int e = 0; e < F; ++e) {
        const int n = j + 16 * e;
        wmma::load_matrix_sync(bf[e], kBTrans ? b + n * ldb + k
                                              : b + k * ldb + n, ldb);
      }
#pragma unroll
      for (int r = 0; r < F; ++r)
#pragma unroll
        for (int e = 0; e < F; ++e)
          wmma::mma_sync(cf[r][e], af[r], bf[e], cf[r][e]);
    }
#pragma unroll
    for (int r = 0; r < F; ++r)
#pragma unroll
      for (int e = 0; e < F; ++e)
        wmma::store_matrix_sync(c + (i + 16 * r) * ldc + j + 16 * e,
                                cf[r][e], ldc, wmma::mem_row_major);
  }
}

// C[M x N] (fp32, pitch ldc) = (acc ? C : 0) + A[M x K] . B[K x N], A and
// B in shared memory, C in shared or device memory (32-byte aligned
// fragments: ldc and the offsets multiples of 8). A(m, k) is
// a[m * lda + k], or a[k * lda + m] when kATrans; B(k, n) is
// b[k * ldb + n], or b[n * ldb + k] when kBTrans. M, N and K are multiples
// of 16. The caller synchronises before (operands staged) and after (C
// complete). Each element of C is summed over k in order by one thread or
// one warp, so the result does not depend on the schedule.
template <typename T, bool kATrans, bool kBTrans, int kNT = kThreads>
__device__ __forceinline__ void mma(float* c, int ldc, const T* a, int lda,
                                    const T* b, int ldb, int M, int N, int K,
                                    bool acc) {
  if constexpr (kHalfWidth<T>) {
    if (((M | N) & 31) == 0)
      mma_blocks<2, kATrans, kBTrans, kNT>(c, ldc, a, lda, b, ldb, M, N, K,
                                           acc);
    else
      mma_blocks<1, kATrans, kBTrans, kNT>(c, ldc, a, lda, b, ldb, M, N, K,
                                           acc);
  } else {
    // rows i + mq * r, columns j + nq * e: neighbouring threads read
    // neighbouring B columns and share their A rows
    const int mq = M / 4, nq = N / 4;
    for (int t = threadIdx.x; t < mq * nq; t += kNT) {
      const int i = t / nq, j = t - (t / nq) * nq;
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[r][e] = acc ? c[(i + mq * r) * ldc + j + nq * e] : 0.f;
      for (int k = 0; k < K; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          av[r] = kATrans ? a[k * lda + i + mq * r] : a[(i + mq * r) * lda + k];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bv[e] = kBTrans ? b[(j + nq * e) * ldb + k] : b[k * ldb + j + nq * e];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[r][e] = fmaf(av[r], bv[e], s[r][e]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[(i + mq * r) * ldc + j + nq * e] = s[r][e];
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Opt a kernel into more than 48 KB of dynamic shared memory; refuse what
// no block can have.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

}  // namespace tile
