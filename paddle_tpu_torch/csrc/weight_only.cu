// Weight-only int8 / int4 linear for Hopper (sm_90a):
//   y[M, N] = x[M, K] . dequant(q[N, K], scale)^T (+ bias), in x's dtype T
// (fp32, bf16 or fp16), the weight int8 [N, K] (int4 is values in
// [-8, 7] in the same bytes), the scale fp32 [N] (per channel) or
// [K / gs, N] (grouped, gs columns a group), the bias [N] in T.
//
// Replaces no Pallas kernel: the reference's `weight_only_linear`
// (paddle_tpu/nn/quant/__init__.py:154) is XLA code, which fuses the
// dequantizing scale into the product's operand read. In PyTorch a
// dequantize followed by a product writes and reads back a full-width
// weight on every call, so this kernel reads the int8 weight once and
// dequantizes it on the way in.
//
// Numerics, those of the plain version (weight_only_linear_ref in
// ops/kernels/weight_only.py): the weight element is q * s rounded to T,
// s being the scale rounded to T first (the product is exact in fp32: q
// has 8 bits, s at most 24); the products sum in fp32; the sum is rounded
// to T and the bias added in T.
//
// Two routes, which the wrapper picks by M:
//  * wo_gemv_kernel (M <= 16, the decode step): CUDA cores. A block of 8
//    warps takes 32 output rows (4 a warp) and one split of K (at most
//    1024 columns); x's rows of that split sit in shared memory as fp32
//    (one padding word every 16, so the warp's reads fall on 32 banks).
//    A lane loads 16 weights of each of its warp's 4 rows with one 16-byte
//    load a row, dequantizes them in registers and keeps fp32 sums for up
//    to 16 rows of x and its 4 rows of the weight; a warp's lanes then add
//    their sums by shuffles. K is split so that an N of 2048 still gives
//    every SM blocks; with more than one split each block writes its fp32
//    partials and wo_combine_kernel adds them in split order, rounds and
//    adds the bias. No float atomics: a second call is bit-identical.
//  * wo_tiled_kernel (M > 16, the prompt pass): 64 x 64 output tiles, K in
//    steps of 32; each step stages x's tile and the weight's tile,
//    dequantized to T, in shared memory and multiplies them on
//    tile_mma.cuh's bodies (wmma for bf16 / fp16, fp32 on CUDA cores),
//    summing into an fp32 tile in shared memory, then rounds and adds the
//    bias. Each output is summed in k order by one thread or one warp.
// A K that is not a multiple of 16, a grouped scale whose group is not, or
// a weight (or, in the tiled route, x) that is not 16-byte aligned takes
// the scalar-load instantiation (kVec false) of the same kernels.
//
// What bounds it on the H100: bytes at decode (the int8 weight, N K bytes,
// against 2 N K in bf16 and 4 N K in fp32), operations at the prompt pass.
// The design reads each weight byte once at decode; making the prompt pass
// fast (wgmma, TMA) is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace wo {

constexpr int kF32 = 0, kBf16 = 1, kF16 = 2;   // the wrapper's dtype codes

// --- the decode route ------------------------------------------------------
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kChunk = 32 * 16;     // columns of one pass of a warp
constexpr int kMaxSplit = 1024;     // columns of K a block at most
constexpr int kMaxM = 16;

// --- the prompt-pass route -------------------------------------------------
constexpr int kBM = 64, kBN = 64, kBK = 32;

// x rounded to T and back (the identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return tile::to_f(tile::from_f<T>(v));
}
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

// The dequantized weight element: q * s_t rounded to T (s_t the scale
// already rounded to T).
template <typename T>
__device__ __forceinline__ float dequant(int q, float s_t) {
  return round_to<T>(__fmul_rn((float)q, s_t));
}

// The scale of weight row n at column k, rounded to T (1 without scales).
template <typename T>
__device__ __forceinline__ float scale_at(const float* scale, int n, int k,
                                          int N, int gs) {
  if (scale == nullptr) return 1.f;
  return round_to<T>(__ldg(gs ? scale + (long long)(k / gs) * N + n
                              : scale + n));
}

// The output element from its fp32 sum: rounded to T, then the bias in T.
template <typename T>
__device__ __forceinline__ T finish(float acc, const T* bias, int n) {
  T y = tile::from_f<T>(acc);
  if (bias != nullptr) y = tile::from_f<T>(tile::to_f(y) + tile::to_f(bias[n]));
  return y;
}

// Byte j (0..3) of a 32-bit word, sign-extended.
__device__ __forceinline__ int sbyte(uint32_t v, int j) {
  return (int)(v << (24 - 8 * j)) >> 24;
}

// Shared-memory index of x's column c (padding word every 16 columns).
__device__ __forceinline__ int xcol(int c) { return c + (c >> 4); }

template <typename T, int MR, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    wo_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const T* __restrict__ bias, T* __restrict__ y,
                   float* __restrict__ part, int M, int N, int K, int gs,
                   int ksplit) {
  extern __shared__ float xs[];
  const int k0 = blockIdx.y * ksplit;
  const int len = min(K - k0, ksplit);
  const int ldx = ksplit + (ksplit >> 4);
  for (int i = threadIdx.x; i < MR * ksplit; i += kWarps * 32) {
    const int m = i / ksplit, c = i - m * ksplit;
    float v = 0.f;
    if (m < M && c < len) v = tile::to_f(x[(long long)m * K + k0 + c]);
    xs[m * ldx + xcol(c)] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  float acc[MR][kRowsPerWarp];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[m][r] = 0.f;

  for (int p = 0; p < len; p += kChunk) {
    const int c = p + lane * 16;          // this lane's 16 columns
    if (c >= len) break;
    const int k = k0 + c;
    uint32_t qw[kRowsPerWarp][4];
    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int n = n0 + r;
      qw[r][0] = qw[r][1] = qw[r][2] = qw[r][3] = 0u;
      sc[r] = 0.f;
      if (n < N) {
        const int8_t* row = w + (long long)n * K + k;
        if constexpr (kVec) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(row));
          qw[r][0] = u.x;
          qw[r][1] = u.y;
          qw[r][2] = u.z;
          qw[r][3] = u.w;
          sc[r] = scale_at<T>(scale, n, k, N, gs);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (c + j < len)
              qw[r][j >> 2] |= (uint32_t)(uint8_t)__ldg(row + j)
                               << (8 * (j & 3));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float xv[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m) xv[m] = xs[m * ldx + xcol(c + j)];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        float s = sc[r];
        if constexpr (!kVec) {
          // a group may change inside the 16 columns here
          const int n = n0 + r;
          s = (n < N && c + j < len) ? scale_at<T>(scale, n, k + j, N, gs)
                                     : 0.f;
        }
        const float wv = dequant<T>(sbyte(qw[r][j >> 2], j & 3), s);
#pragma unroll
        for (int m = 0; m < MR; ++m) acc[m][r] = fmaf(xv[m], wv, acc[m][r]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float v = tile::warp_sum(acc[m][r]);
      const int n = n0 + r;
      if (lane == ((m * kRowsPerWarp + r) & 31) && m < M && n < N) {
        if (gridDim.y == 1)
          y[(long long)m * N + n] = finish<T>(v, bias, n);
        else
          part[((long long)blockIdx.y * M + m) * N + n] = v;
      }
    }
}

// The split-K partials [splits, M, N] added in split order.
template <typename T>
__global__ void __launch_bounds__(256)
    wo_combine_kernel(const float* __restrict__ part,
                      const T* __restrict__ bias, T* __restrict__ y, int M,
                      int N, int splits) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[sp * mn + i];
  y[i] = finish<T>(s, bias, (int)(i % N));
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(tile::kThreads)
    wo_tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const T* __restrict__ bias, T* __restrict__ y, int M,
                    int N, int K, int gs) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ldt = tile::pitch<T>(kBK);
  constexpr int ldc = kBN + 8;
  size_t off = 0;
  T* xs = reinterpret_cast<T*>(smem + tile::take(off, kBM * ldt * sizeof(T)));
  T* ws = reinterpret_cast<T*>(smem + tile::take(off, kBN * ldt * sizeof(T)));
  float* cs = reinterpret_cast<float*>(
      smem + tile::take(off, kBM * ldc * sizeof(float)));
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const T zero = tile::from_f<T>(0.f);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    if constexpr (kVec) {
      // x: 16-byte pieces of kVx elements; the weight: 16 bytes a thread
      constexpr int kVx = 16 / sizeof(T), kPx = kBK / kVx;
      for (int i = threadIdx.x; i < kBM * kPx; i += tile::kThreads) {
        const int r = i / kPx, c = (i - r * kPx) * kVx;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M && k0 + c < K)
          u = __ldg(reinterpret_cast<const uint4*>(
              x + (long long)(m0 + r) * K + k0 + c));
        *reinterpret_cast<uint4*>(xs + r * ldt + c) = u;
      }
      for (int i = threadIdx.x; i < kBN * (kBK / 16); i += tile::kThreads) {
        const int r = i / (kBK / 16), c = (i - r * (kBK / 16)) * 16;
        const int n = n0 + r, k = k0 + c;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        float s = 0.f;
        if (n < N && k < K) {
          u = __ldg(reinterpret_cast<const uint4*>(w + (long long)n * K + k));
          s = scale_at<T>(scale, n, k, N, gs);
        }
        const uint32_t q[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          ws[r * ldt + c + j] =
              tile::from_f<T>(dequant<T>(sbyte(q[j >> 2], j & 3), s));
      }
    } else {
      for (int i = threadIdx.x; i < kBM * kBK; i += tile::kThreads) {
        const int r = i / kBK, c = i - r * kBK;
        xs[r * ldt + c] = (m0 + r < M && k0 + c < K)
                              ? x[(long long)(m0 + r) * K + k0 + c]
                              : zero;
      }
      for (int i = threadIdx.x; i < kBN * kBK; i += tile::kThreads) {
        const int r = i / kBK, c = i - r * kBK;
        const int n = n0 + r, k = k0 + c;
        float v = 0.f;
        if (n < N && k < K)
          v = dequant<T>(w[(long long)n * K + k],
                         scale_at<T>(scale, n, k, N, gs));
        ws[r * ldt + c] = tile::from_f<T>(v);
      }
    }
    __syncthreads();
    tile::mma<T, false, true>(cs, ldc, xs, ldt, ws, ldt, kBM, kBN, kBK,
                              k0 > 0);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < kBM * kBN; i += tile::kThreads) {
    const int r = i / kBN, c = i - r * kBN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) y[(long long)m * N + n] = finish<T>(cs[r * ldc + c], bias, n);
  }
}

template <typename T>
size_t tiled_smem() {
  size_t off = 0;
  tile::take(off, kBM * tile::pitch<T>(kBK) * sizeof(T));
  tile::take(off, kBN * tile::pitch<T>(kBK) * sizeof(T));
  tile::take(off, kBM * (kBN + 8) * sizeof(float));
  return off;
}

template <typename T, int MR, bool kVec>
cudaError_t gemv(const void* x, const void* w, const void* scale,
                 const void* bias, void* y, void* part, int M, int N, int K,
                 int gs, int ksplit, cudaStream_t stream) {
  const int splits = (K + ksplit - 1) / ksplit;
  const size_t smem = (size_t)MR * (ksplit + (ksplit >> 4)) * sizeof(float);
  auto kernel = wo_gemv_kernel<T, MR, kVec>;
  cudaError_t err = tile::prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, splits);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      (const T*)x, (const int8_t*)w, (const float*)scale, (const T*)bias,
      (T*)y, (float*)part, M, N, K, gs, ksplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  wo_combine_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (const T*)bias, (T*)y, M, N, splits);
  return cudaGetLastError();
}

template <typename T, bool kVec>
cudaError_t gemv_rows(const void* x, const void* w, const void* scale,
                      const void* bias, void* y, void* part, int M, int N,
                      int K, int gs, int ksplit, cudaStream_t stream) {
  if (M <= 1)
    return gemv<T, 1, kVec>(x, w, scale, bias, y, part, M, N, K, gs, ksplit,
                            stream);
  if (M <= 2)
    return gemv<T, 2, kVec>(x, w, scale, bias, y, part, M, N, K, gs, ksplit,
                            stream);
  if (M <= 4)
    return gemv<T, 4, kVec>(x, w, scale, bias, y, part, M, N, K, gs, ksplit,
                            stream);
  if (M <= 8)
    return gemv<T, 8, kVec>(x, w, scale, bias, y, part, M, N, K, gs, ksplit,
                            stream);
  return gemv<T, 16, kVec>(x, w, scale, bias, y, part, M, N, K, gs, ksplit,
                           stream);
}

template <typename T>
cudaError_t gemv_dtype(const void* x, const void* w, const void* scale,
                       const void* bias, void* y, void* part, int M, int N,
                       int K, int gs, int ksplit, int vec,
                       cudaStream_t stream) {
  return vec ? gemv_rows<T, true>(x, w, scale, bias, y, part, M, N, K, gs,
                                  ksplit, stream)
             : gemv_rows<T, false>(x, w, scale, bias, y, part, M, N, K, gs,
                                   ksplit, stream);
}

template <typename T, bool kVec>
cudaError_t tiled(const void* x, const void* w, const void* scale,
                  const void* bias, void* y, int M, int N, int K, int gs,
                  cudaStream_t stream) {
  const size_t smem = tiled_smem<T>();
  auto kernel = wo_tiled_kernel<T, kVec>;
  cudaError_t err = tile::prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, tile::kThreads, smem, stream>>>(
      (const T*)x, (const int8_t*)w, (const float*)scale, (const T*)bias,
      (T*)y, M, N, K, gs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t tiled_dtype(const void* x, const void* w, const void* scale,
                        const void* bias, void* y, int M, int N, int K,
                        int gs, int vec, cudaStream_t stream) {
  return vec ? tiled<T, true>(x, w, scale, bias, y, M, N, K, gs, stream)
             : tiled<T, false>(x, w, scale, bias, y, M, N, K, gs, stream);
}

}  // namespace wo

// Columns of K one block of the decode route takes at most, and the
// columns of one warp pass (the wrapper's split is a multiple of it).
extern "C" int wo_max_split() { return wo::kMaxSplit; }
extern "C" int wo_chunk() { return wo::kChunk; }
extern "C" int wo_max_gemv_rows() { return wo::kMaxM; }

// The decode route: M <= 16 rows of x. `part` holds [splits, M, N] fp32
// when K > ksplit (splits = ceil(K / ksplit)); ksplit is a multiple of
// wo_chunk() and at most wo_max_split(). gs is the group size of a
// grouped scale, 0 for a per-channel one; `scale` and `bias` may be null.
extern "C" int wo_gemv(const void* x, const void* w, const void* scale,
                       const void* bias, void* y, void* part, int M, int N,
                       int K, int gs, int ksplit, int dtype, int vec,
                       void* stream) {
  if (M < 1 || M > wo::kMaxM || N < 1 || K < 1 || ksplit < wo::kChunk ||
      ksplit > wo::kMaxSplit || ksplit % wo::kChunk || gs < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == wo::kBf16)
    return (int)wo::gemv_dtype<__nv_bfloat16>(x, w, scale, bias, y, part, M,
                                              N, K, gs, ksplit, vec, s);
  if (dtype == wo::kF16)
    return (int)wo::gemv_dtype<__half>(x, w, scale, bias, y, part, M, N, K,
                                       gs, ksplit, vec, s);
  if (dtype == wo::kF32)
    return (int)wo::gemv_dtype<float>(x, w, scale, bias, y, part, M, N, K,
                                      gs, ksplit, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The prompt-pass route: any M.
extern "C" int wo_tiled(const void* x, const void* w, const void* scale,
                        const void* bias, void* y, int M, int N, int K,
                        int gs, int dtype, int vec, void* stream) {
  if (M < 1 || N < 1 || K < 1 || gs < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == wo::kBf16)
    return (int)wo::tiled_dtype<__nv_bfloat16>(x, w, scale, bias, y, M, N, K,
                                               gs, vec, s);
  if (dtype == wo::kF16)
    return (int)wo::tiled_dtype<__half>(x, w, scale, bias, y, M, N, K, gs,
                                        vec, s);
  if (dtype == wo::kF32)
    return (int)wo::tiled_dtype<float>(x, w, scale, bias, y, M, N, K, gs, vec,
                                       s);
  return (int)cudaErrorInvalidValue;
}
