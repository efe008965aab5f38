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
// Four routes, which the wrapper picks by x's dtype, M and K, the group
// size and the alignment (ops/kernels/weight_only.py `route`) before the
// launch; each is counted on its own.
//
// bf16 / fp16 x, K and the group a multiple of 16, x and the weight
// 16-byte aligned (the Hopper design):
//  * wo_mma_kernel (M <= 16, the decode step): tensor cores by
//    mma.sync.m16n8k16 with fp32 accumulators, computing y^T = W . x^T:
//    sixteen weight rows are the instruction's A side, x's rows its n8
//    columns (a second n8 tile for M 9-16). A block of 4 warps takes 64
//    weight rows (16 a warp) and one split of K. Lane (g, t) loads 16
//    contiguous bytes of weight rows g and g + 8 at columns [16 t, 16 t +
//    16) of each 64-column span, 4 spans a pass, the next pass loading
//    while this one's products run (16 loads of 16 bytes in flight a
//    lane). Those 16 bytes are its A fragment of the span's four
//    k16 steps with no shuffle: k is permuted inside each 64 columns the
//    same way in both operands (step j's slots 2t, 2t+1, 2t+8, 2t+9 are
//    columns 16 t + 4 j + 0..3), and the lane reads x's same 16 columns
//    from shared memory, where x's rows of the split are staged once a
//    block in their own order (rows 16 bytes past a multiple of 128 apart:
//    no bank conflicts). Dequantizing runs in registers at the full rate:
//    a byte put under fp32's 2^23 by a byte permute, less 2^23 + 128, is
//    the int exactly; its high half is that int in bf16 (for fp16 a byte
//    under 1024 in each half, less 1152); then one bf16x2 / half2 multiply
//    by the row's scale pair, the contract's single rounding (q has at
//    most 8 significant bits and s_T at most 11, so q * s_T is exact in
//    fp32 and the fma's one rounding to T is that of the plain version).
//    No int-to-float conversion in the loop, and a float-to-16-bit one
//    only for a grouped scale (one a 16-weight chunk). K is split
//    (`mma_plan`) so that every SM has two blocks; each split writes fp32
//    partials and wo_combine_kernel adds them in split order.
//  * wo_wgmma_kernel<T, BN> (M > 16, the prompt pass, the speculative
//    verify, a chunk): warpgroup products on hopper_tiles.cuh. A block
//    takes 128 weight rows and BN (64, 128 or 256, by M) tokens; a producer
//    warp keeps a ring of 4 stages full by TMA (x's tile, 128-byte swizzle;
//    the int8 weight's 128 x 64 tile, no swizzle) under full / empty
//    mbarriers. Each of the two consumer warpgroups dequantizes its 64
//    weight rows of the stage once (the same register arithmetic, 16
//    bytes a chunk, two chunks a thread) into a swizzled bf16 / fp16 panel
//    (two panels a warpgroup, alternating), fences it for the async proxy
//    and, after a warpgroup barrier, issues m64nBNk16 wgmma with both
//    operands from shared memory (SS: yT = W . xT, the panel as A and x's
//    tile as B), the fp32 sums in registers. The next stage is
//    dequantized while the products run. The epilogue rounds to T, adds
//    the bias, and writes y through shared memory transposed to [M, N]
//    rows; a grid smaller than the card splits K (`wgmma_plan`), and the
//    splits' fp32 partials are added in order by wo_combine_kernel.
//    SS and not RS (A from registers): an RS fragment wants bytes 2t, 2t+1,
//    2t+8, 2t+9 of each k16 step, which from a TMA tile is two-byte loads
//    or quad shuffles a thread a step; the SS pass reads 16 bytes and
//    writes 32 a chunk with no bank conflicts.
//
// The first design, which fp32 x (true fp32: TF32 is off) and the shapes
// the routes above refuse keep:
//  * wo_gemv_kernel (M <= 16): CUDA cores. A block of 8
//    warps takes 32 output rows (4 a warp) and one split of K (at most
//    1024 columns); x's rows of that split sit in shared memory as fp32
//    (one padding word every 16, so the warp's reads fall on 32 banks).
//    A lane loads 16 weights of each of its warp's 4 rows with one 16-byte
//    load a row, dequantizes them in registers and keeps fp32 sums for up
//    to 16 rows of x and its 4 rows of the weight; a warp's lanes then add
//    their sums by shuffles. K is split so that an N of 2048 still gives
//    every SM blocks; with more than one split each block writes its fp32
//    partials and wo_combine_kernel adds them in split order, rounds and
//    adds the bias.
//  * wo_tiled_kernel (M > 16): 64 x 64 output tiles, K in
//    steps of 32; each step stages x's tile and the weight's tile,
//    dequantized to T, in shared memory and multiplies them on
//    tile_mma.cuh's bodies (wmma for bf16 / fp16, fp32 on CUDA cores),
//    summing into an fp32 tile in shared memory, then rounds and adds the
//    bias. Each output is summed in k order by one thread or one warp.
// A K that is not a multiple of 16, a grouped scale whose group is not, or
// a weight (or, in the tiled route, x) that is not 16-byte aligned takes
// the scalar-load instantiation (kVec false) of the first design; the
// tiled route's vectorized one is built for fp32 x alone.
// No route uses float atomics: a second call is bit-identical.
//
// What bounds it on the H100: bytes at decode (the int8 weight, N K bytes,
// against 2 N K in bf16 and 4 N K in fp32), operations at the prompt pass.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tiles.cuh"
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

// bf16 / fp16 x reach the tiled route only with the shapes the Hopper
// routes refuse, which all take the scalar loads: only fp32 x has the
// vectorized instantiation.
template <typename T>
cudaError_t tiled_dtype(const void* x, const void* w, const void* scale,
                        const void* bias, void* y, int M, int N, int K,
                        int gs, int vec, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    if (vec) return tiled<T, true>(x, w, scale, bias, y, M, N, K, gs, stream);
  } else if (vec) {
    return cudaErrorInvalidValue;
  }
  return tiled<T, false>(x, w, scale, bias, y, M, N, K, gs, stream);
}

// ---------------------------------------------------------------------------
// the Hopper design: dequantizing in registers
// ---------------------------------------------------------------------------

// bf16x2 / half2 products a * b with one rounding (fma with -0: the sign
// of an exact zero kept).
template <typename T>
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b);
template <>
__device__ __forceinline__ uint32_t mul2<__nv_bfloat16>(uint32_t a,
                                                        uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}
template <>
__device__ __forceinline__ uint32_t mul2<__half>(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.f16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// T's bits of v rounded to nearest even, and T's bits as a float (by
// cvt and shifts on 16-bit registers: no local copy whose address is
// taken, which costs a stack frame).
template <typename T>
__device__ __forceinline__ uint16_t bits_of(float v) {
  uint16_t h;
  if constexpr (std::is_same<T, __half>::value)
    asm("cvt.rn.f16.f32 %0, %1;" : "=h"(h) : "f"(v));
  else
    asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(v));
  return h;
}
template <typename T>
__device__ __forceinline__ float from_bits(uint16_t h) {
  if constexpr (std::is_same<T, __half>::value) {
    float f;
    asm("cvt.f32.f16 %0, %1;" : "=f"(f) : "h"(h));
    return f;
  } else {
    return __uint_as_float((uint32_t)h << 16);
  }
}

// The scale s rounded to T, in both halves of a 32-bit pair.
template <typename T>
__device__ __forceinline__ uint32_t pair_of(float s) {
  const uint32_t b = bits_of<T>(s);
  return b | (b << 16);
}

// The output element's bits from its fp32 sum: rounded to T, then the
// bias (T's bits) added in T (`finish`).
template <typename T>
__device__ __forceinline__ uint16_t finish_bits(float acc,
                                                const uint16_t* bias, int n) {
  uint16_t y = bits_of<T>(acc);
  if (bias != nullptr)
    y = bits_of<T>(from_bits<T>(y) + from_bits<T>(__ldg(bias + n)));
  return y;
}

// The scale pair of weight row n at column k (1 without scales, 0 past N
// or K, where the weight is 0 too).
template <typename T>
__device__ __forceinline__ uint32_t scale_pair(const float* scale, int n,
                                               int k, int N, int K, int gs) {
  if (scale == nullptr) return pair_of<T>(1.f);
  if (n >= N || k >= K) return 0u;
  return pair_of<T>(
      __ldg(gs ? scale + (long long)(k / gs) * N + n : scale + n));
}

// The four int8 weights of a 32-bit word, dequantized: (lo, hi) hold the
// pairs (0, 1) and (2, 3) in T, each q * s_T rounded once to T. The ints
// become floats by byte permutes and one add each, at the full rate:
// bf16: 2^23 + (q + 128) in fp32, less 2^23 + 128, is q exactly, and its
// high half is q in bf16 (8 significant bits at most); fp16: 1024 + (q +
// 128) in each half, less 1152.
template <typename T>
__device__ __forceinline__ void dequant4(uint32_t v, uint32_t s2,
                                         uint32_t& lo, uint32_t& hi);
template <>
__device__ __forceinline__ void dequant4<__nv_bfloat16>(uint32_t v,
                                                        uint32_t s2,
                                                        uint32_t& lo,
                                                        uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) -
                   8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) -
                   8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) -
                   8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) -
                   8388736.f;
  lo = mul2<__nv_bfloat16>(
      __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632), s2);
  hi = mul2<__nv_bfloat16>(
      __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632), s2);
}
template <>
__device__ __forceinline__ void dequant4<__half>(uint32_t v, uint32_t s2,
                                                 uint32_t& lo,
                                                 uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  uint32_t a = __byte_perm(u, 0x64646464u, 0x4140);
  uint32_t b = __byte_perm(u, 0x64646464u, 0x4342);
  asm("sub.rn.f16x2 %0, %0, %1;" : "+r"(a) : "r"(0x64806480u));
  asm("sub.rn.f16x2 %0, %0, %1;" : "+r"(b) : "r"(0x64806480u));
  lo = mul2<__half>(a, s2);
  hi = mul2<__half>(b, s2);
}

// ---------------------------------------------------------------------------
// the decode route on tensor cores: mma.sync.m16n8k16
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;        // weight rows a block
constexpr int kMmaSpan = 64;                    // columns a 16-byte load covers
constexpr int kMmaUnroll = 4;                   // spans a pass
constexpr int kMmaStep = kMmaSpan * kMmaUnroll; // a split is a multiple
constexpr int kMmaMaxSplit = 2048;

// d[16 x 8] += a[16 x 16] . b[16 x 8], fp32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3},"
        " {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A lane's weight bytes of the pass at column p of its split: 16 bytes of
// rows g and g + 8 in each of the pass's spans, zeros past the split or N.
__device__ __forceinline__ void mma_loads(uint4 (&q0)[kMmaUnroll],
                                          uint4 (&q1)[kMmaUnroll],
                                          const int8_t* w0, const int8_t* w1,
                                          int p, int len, int t, bool v0,
                                          bool v1) {
#pragma unroll
  for (int u = 0; u < kMmaUnroll; ++u) {
    const int c = p + u * kMmaSpan;
    const bool in = c + 16 * t < len;
    q0[u] = q1[u] = make_uint4(0u, 0u, 0u, 0u);
    if (in && v0) q0[u] = __ldg(reinterpret_cast<const uint4*>(w0 + c));
    if (in && v1) q1[u] = __ldg(reinterpret_cast<const uint4*>(w1 + c));
  }
}

// x's staged row pitch (elements): 16 bytes past a multiple of 128.
__host__ __device__ constexpr int mma_ldx(int ksplit) { return ksplit + 8; }

template <int NT>
size_t mma_smem(int ksplit) {
  return (size_t)8 * NT * mma_ldx(ksplit) * 2;
}

// NT n8 tiles of x's rows: 1 for M <= 8, 2 for M <= 16; kGroup: a
// grouped scale (one a row and 16-column chunk, loaded a pass), else one
// a row, loaded once (a branch on gs inside the loop cost a spill).
template <typename T, int NT, bool kGroup>
__global__ void __launch_bounds__(kMmaWarps * 32)
    wo_mma_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  const T* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ part, int M, int N, int K, int gs,
                  int ksplit) {
  extern __shared__ __align__(16) unsigned char xs_raw[];
  T* xs = reinterpret_cast<T*>(xs_raw);
  const int k0 = blockIdx.y * ksplit;
  const int len = min(K - k0, ksplit);            // a multiple of 16
  const int ldx = mma_ldx(ksplit);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kMmaRows + warp * 16 + g, r1 = r0 + 8;
  const int8_t* w0 = w + (long long)min(r0, N - 1) * K + k0 + 16 * t;
  const int8_t* w1 = w + (long long)min(r1, N - 1) * K + k0 + 16 * t;
  const int pieces = ksplit / 8;                  // 16 bytes each
  for (int i = threadIdx.x; i < 8 * NT * pieces; i += kMmaWarps * 32) {
    const int m = i / pieces, c = (i - m * pieces) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (m < M && c < len)
      u = __ldg(reinterpret_cast<const uint4*>(x + (long long)m * K + k0 +
                                               c));
    *reinterpret_cast<uint4*>(xs + m * ldx + c) = u;
  }
  __syncthreads();
  // the pass after the one in the products is in flight: 16 loads of
  // 16 bytes a lane (issued before x is staged, the first pass spilled
  // and ran slower)
  uint4 q0[kMmaUnroll], q1[kMmaUnroll];
  mma_loads(q0, q1, w0, w1, 0, len, t, r0 < N, r1 < N);

  uint32_t s0 = 0u, s1 = 0u;
  if constexpr (!kGroup) {
    s0 = scale_pair<T>(scale, r0, 0, N, K, 0);
    s1 = scale_pair<T>(scale, r1, 0, N, K, 0);
  }
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int p = 0; p < len; p += kMmaStep) {
    uint4 n0[kMmaUnroll], n1[kMmaUnroll];
    mma_loads(n0, n1, w0, w1, p + kMmaStep, len, t, r0 < N, r1 < N);
    uint32_t g0[kMmaUnroll], g1[kMmaUnroll];
    if constexpr (kGroup) {
#pragma unroll
      for (int u = 0; u < kMmaUnroll; ++u) {
        const int k = k0 + p + u * kMmaSpan + 16 * t;
        g0[u] = scale_pair<T>(scale, r0, k, N, k0 + len, gs);
        g1[u] = scale_pair<T>(scale, r1, k, N, k0 + len, gs);
      }
    }
#pragma unroll
    for (int u = 0; u < kMmaUnroll; ++u) {
      const int c = p + u * kMmaSpan + 16 * t;
      if constexpr (kGroup) {
        s0 = g0[u];
        s1 = g1[u];
      }
      uint32_t xw[NT][8];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* xr = xs + (8 * nt + g) * ldx + c;
        const uint4 a = *reinterpret_cast<const uint4*>(xr);
        const uint4 b = *reinterpret_cast<const uint4*>(xr + 8);
        xw[nt][0] = a.x, xw[nt][1] = a.y, xw[nt][2] = a.z, xw[nt][3] = a.w;
        xw[nt][4] = b.x, xw[nt][5] = b.y, xw[nt][6] = b.z, xw[nt][7] = b.w;
      }
      const uint32_t wa[4] = {q0[u].x, q0[u].y, q0[u].z, q0[u].w};
      const uint32_t wb[4] = {q1[u].x, q1[u].y, q1[u].z, q1[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t a[4];
        dequant4<T>(wa[j], s0, a[0], a[2]);
        dequant4<T>(wb[j], s1, a[1], a[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma16816<T>(acc[nt], a, xw[nt][2 * j], xw[nt][2 * j + 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < kMmaUnroll; ++u) {
      q0[u] = n0[u];
      q1[u] = n1[u];
    }
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = e < 2 ? r0 : r1, m = 8 * nt + 2 * t + (e & 1);
      if (m < M && n < N) {
        if (gridDim.y == 1)
          reinterpret_cast<uint16_t*>(y)[(long long)m * N + n] =
              finish_bits<T>(acc[nt][e],
                             reinterpret_cast<const uint16_t*>(bias), n);
        else
          part[((long long)blockIdx.y * M + m) * N + n] = acc[nt][e];
      }
    }
}

// ---------------------------------------------------------------------------
// the prompt route on warpgroup products (hopper_tiles.cuh)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kBM = 128;                 // weight rows a block
constexpr int kBK = 64;                  // columns of K a stage
constexpr int kStages = 4;
constexpr int kWBytes = kBM * kBK;       // the int8 tile, 8 KB
constexpr int kPanel = 64 * hop::kRowBytes;  // a warpgroup's dequantized tile

template <int BN>
struct Layout {
  static constexpr int kXBytes = BN * hop::kRowBytes;   // x's tile
  static constexpr int kStage = kXBytes + kWBytes;
  static constexpr int kPanels = kStages * kStage;      // 2 a warpgroup
  static constexpr int kBars = kPanels + 4 * kPanel;
  static constexpr size_t kSmem = kBars + 2 * kStages * 8 + 1024;
  static constexpr int kLdo = kBM + 8;   // the epilogue's [BN, kLdo] tile
  static_assert(BN * kLdo * 2 <= kPanels, "epilogue tile in the ring");
};

// A barrier over one consumer warpgroup (ids 1 and 2) or both (id 3).
__device__ __forceinline__ void sync_threads(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

}  // namespace wg

template <typename T, int BN>
__global__ void __launch_bounds__(hop::kThreads, 1)
    wo_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    const float* __restrict__ scale,
                    const T* __restrict__ bias, T* __restrict__ y,
                    float* __restrict__ part, int M, int N, int K, int gs,
                    int kper) {
  using L = wg::Layout<BN>;
  constexpr bool kF16 = std::is_same<T, __half>::value;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hop::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* empty = full + wg::kStages;
  const int n0 = blockIdx.x * wg::kBM, m0 = blockIdx.y * BN;
  const int ks0 = blockIdx.z * kper;
  const int steps = min(kper, (K + wg::kBK - 1) / wg::kBK - ks0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < wg::kStages; ++s) {
      hop::bar_init(&full[s], 1);
      hop::bar_init(&empty[s], hop::kConsumers);
    }
    hop::bar_fence_init();
  }
  __syncthreads();

  if (tid >= hop::kConsumers) {
    if (tid == hop::kConsumers) {   // producer
      hop::Ring ring(wg::kStages, 1);
      for (int s = 0; s < steps; ++s, ring.advance()) {
        hop::bar_wait(&empty[ring.stage], ring.phase);
        uint64_t* bar = &full[ring.stage];
        hop::bar_arrive_tx(bar, L::kStage);
        unsigned char* st = sm + ring.stage * L::kStage;
        const int k = (ks0 + s) * wg::kBK;
        hop::load_2d(st, &tx, bar, k, m0);
        hop::load_2d(st + L::kXBytes, &tw, bar, k, n0);
      }
    }
    return;
  }

  // consumer warpgroup wg: weight rows [n0 + 64 wg, + 64). Thread lt
  // dequantizes chunks lt and lt + 128 of its 64 x 64 int8 tile: rows
  // lt / 4 and lt / 4 + 32, columns [16 (lt % 4), + 16).
  const int wgi = tid >> 7, lt = tid & 127, cq = lt & 3;
  const int rows[2] = {lt >> 2, (lt >> 2) + 32};
  uint32_t s2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    s2[i] = scale_pair<T>(scale, n0 + 64 * wgi + rows[i], 0, N, K, 0);
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  hop::fence_regs(acc);
  const uint32_t base = hop::smem_addr(sm);
  hop::Ring ring(wg::kStages, 0);
  int held = -1;   // the stage the batch in flight reads
  for (int s = 0; s < steps; ++s, ring.advance()) {
    hop::bar_wait(&full[ring.stage], ring.phase);
    const unsigned char* st = sm + ring.stage * L::kStage;
    const unsigned char* wt = st + L::kXBytes + wgi * 64 * wg::kBK;
    // the panel the batch before the one in flight read: free (wait<1>)
    const int pi = wgi * 2 + (s & 1);
    unsigned char* panel = sm + L::kPanels + pi * wg::kPanel;
    const int k = (ks0 + s) * wg::kBK + 16 * cq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rows[i];
      const uint4 q =
          *reinterpret_cast<const uint4*>(wt + r * wg::kBK + 16 * cq);
      const uint32_t sp =
          gs ? scale_pair<T>(scale, n0 + 64 * wgi + r, k, N, K, gs) : s2[i];
      uint4 lo, hi;
      dequant4<T>(q.x, sp, lo.x, lo.y);
      dequant4<T>(q.y, sp, lo.z, lo.w);
      dequant4<T>(q.z, sp, hi.x, hi.y);
      dequant4<T>(q.w, sp, hi.z, hi.w);
      *reinterpret_cast<uint4*>(panel + hop::sw128(r, 16 * cq)) = lo;
      *reinterpret_cast<uint4*>(panel + hop::sw128(r, 16 * cq + 8)) = hi;
    }
    hop::fence_async_smem();
    wg::sync_threads(1 + wgi, 128);
    const uint32_t pa = base + L::kPanels + pi * wg::kPanel;
    const uint32_t pb = base + ring.stage * L::kStage;
    hop::fence_regs(acc);
    hop::fence();
#pragma unroll
    for (int kk = 0; kk < wg::kBK / 16; ++kk)
      hop::mma_ss<BN, 0, 0, kF16>(acc, hop::desc(pa + kk * 32, 16, 1024),
                                  hop::desc(pb + kk * 32, 16, 1024), 1);
    hop::commit();
    hop::wait<1>();   // the previous step's batch is done: free its stage
    hop::fence_regs(acc);
    if (held >= 0) hop::bar_arrive(&empty[held]);
    held = ring.stage;
  }
  hop::wait<0>();
  hop::fence_regs(acc);

  // accumulator element i: weight row n0 + 64 wg + acc_row, token m0 +
  // acc_col; elements 0-1 share a row, as do 2-3 (the row 8 below)
  const int nr = n0 + 64 * wgi;
  if (part != nullptr) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int n = nr + hop::acc_row(lt, i), m = m0 + hop::acc_col(lt, i);
      if (m < M && n < N)
        part[((long long)blockIdx.z * M + m) * N + n] = acc[i];
    }
    return;
  }
  // y through shared memory: [BN tokens, 128 rows] in T, then rows of y
  wg::sync_threads(3, hop::kConsumers);   // both warpgroups are off the ring
  uint16_t* out = reinterpret_cast<uint16_t*>(sm);
  const uint16_t* b16 = reinterpret_cast<const uint16_t*>(bias);
  float bsum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = nr + hop::acc_row(lt, 2 * h);
    if (bias != nullptr && n < N) bsum[h] = from_bits<T>(__ldg(b16 + n));
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    uint16_t v = bits_of<T>(acc[i]);
    if (bias != nullptr)
      v = bits_of<T>(from_bits<T>(v) + bsum[(i >> 1) & 1]);
    out[hop::acc_col(lt, i) * L::kLdo + 64 * wgi + hop::acc_row(lt, i)] = v;
  }
  wg::sync_threads(3, hop::kConsumers);
  const bool vec = (N & 7) == 0;
  for (int p = tid; p < BN * (wg::kBM / 8); p += hop::kConsumers) {
    const int r = p / (wg::kBM / 8), c = (p - r * (wg::kBM / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const uint16_t* src = out + r * L::kLdo + c;
    uint16_t* dst = reinterpret_cast<uint16_t*>(y) + (long long)m * N + n;
    if (vec)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else
      for (int e = 0; e < 8 && n + e < N; ++e) dst[e] = src[e];
  }
}

// ---------------------------------------------------------------------------
// launchers of the Hopper design
// ---------------------------------------------------------------------------

template <typename T, int NT>
cudaError_t mma(const void* x, const void* w, const void* scale,
                const void* bias, void* y, void* part, int M, int N, int K,
                int gs, int ksplit, cudaStream_t stream) {
  const int splits = (K + ksplit - 1) / ksplit;
  const size_t smem = mma_smem<NT>(ksplit);
  auto kernel =
      gs ? wo_mma_kernel<T, NT, true> : wo_mma_kernel<T, NT, false>;
  cudaError_t err = tile::prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kMmaRows - 1) / kMmaRows, splits);
  kernel<<<grid, kMmaWarps * 32, smem, stream>>>(
      (const T*)x, (const int8_t*)w, (const float*)scale, (const T*)bias,
      (T*)y, (float*)part, M, N, K, gs, ksplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  wo_combine_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (const T*)bias, (T*)y, M, N, splits);
  return cudaGetLastError();
}

template <typename T>
CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T, int BN>
cudaError_t wgmma(const void* x, const void* w, const void* scale,
                  const void* bias, void* y, void* part, int M, int N, int K,
                  int gs, int kper, cudaStream_t stream) {
  using L = wg::Layout<BN>;
  const long long x_dims[2] = {K, M}, w_dims[2] = {K, N};
  const long long stride[1] = {K};
  const int x_box[2] = {wg::kBK, BN}, w_box[2] = {wg::kBK, wg::kBM};
  CUtensorMap tx, tw;
  auto kernel = wo_wgmma_kernel<T, BN>;
  cudaError_t err;
  if ((err = hop::make_map_of(&tx, x, 2, x_dims, stride, x_box,
                              map_type<T>(), 2, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (err = hop::make_map_of(&tw, w, 2, w_dims, stride, w_box,
                              CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                              CU_TENSOR_MAP_SWIZZLE_NONE)) ||
      (err = hop::prepare(kernel, L::kSmem)))
    return err;
  const int steps = (K + wg::kBK - 1) / wg::kBK;
  const int splits = (steps + kper - 1) / kper;
  dim3 grid((N + wg::kBM - 1) / wg::kBM, (M + BN - 1) / BN, splits);
  kernel<<<grid, hop::kThreads, L::kSmem, stream>>>(
      tx, tw, (const float*)scale, (const T*)bias, (T*)y,
      splits > 1 ? (float*)part : nullptr, M, N, K, gs, kper);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long mn = (long long)M * N;
  wo_combine_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (const T*)bias, (T*)y, M, N, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mma_dtype(const void* x, const void* w, const void* scale,
                      const void* bias, void* y, void* part, int M, int N,
                      int K, int gs, int ksplit, cudaStream_t stream) {
  return M <= 8 ? mma<T, 1>(x, w, scale, bias, y, part, M, N, K, gs, ksplit,
                            stream)
                : mma<T, 2>(x, w, scale, bias, y, part, M, N, K, gs, ksplit,
                            stream);
}

template <typename T>
cudaError_t wgmma_dtype(const void* x, const void* w, const void* scale,
                        const void* bias, void* y, void* part, int M, int N,
                        int K, int gs, int bn, int kper,
                        cudaStream_t stream) {
  if (bn == 64)
    return wgmma<T, 64>(x, w, scale, bias, y, part, M, N, K, gs, kper,
                        stream);
  if (bn == 128)
    return wgmma<T, 128>(x, w, scale, bias, y, part, M, N, K, gs, kper,
                         stream);
  return wgmma<T, 256>(x, w, scale, bias, y, part, M, N, K, gs, kper, stream);
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

// The decode route on tensor cores (bf16 / fp16 x, M <= 16, K and gs
// multiples of 16, x and w 16-byte aligned). `part` holds [splits, M, N]
// fp32 when K > ksplit; ksplit is a multiple of wo_mma_step() and at most
// wo_mma_max_split().
extern "C" int wo_mma(const void* x, const void* w, const void* scale,
                           const void* bias, void* y, void* part, int M,
                           int N, int K, int gs, int ksplit, int dtype,
                           void* stream) {
  if (M < 1 || M > wo::kMaxM || N < 1 || K < 16 || K % 16 || gs < 0 ||
      gs % 16 || ksplit < wo::kMmaStep || ksplit > wo::kMmaMaxSplit ||
      ksplit % wo::kMmaStep)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == wo::kBf16)
    return (int)wo::mma_dtype<__nv_bfloat16>(x, w, scale, bias, y, part, M,
                                             N, K, gs, ksplit, s);
  if (dtype == wo::kF16)
    return (int)wo::mma_dtype<__half>(x, w, scale, bias, y, part, M, N, K,
                                      gs, ksplit, s);
  return (int)cudaErrorInvalidValue;
}

// The prompt route on warpgroup products (bf16 / fp16 x, M > 16, the same
// shape rules): token tiles of bn (64, 128 or 256), K split into pieces of
// kper steps of 64 columns; `part` holds [splits, M, N] fp32 when there
// is more than one.
extern "C" int wo_wgmma(const void* x, const void* w, const void* scale,
                        const void* bias, void* y, void* part, int M, int N,
                        int K, int gs, int bn, int kper, int dtype,
                        void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 || gs < 0 || gs % 16 || kper < 1 ||
      (bn != 64 && bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == wo::kBf16)
    return (int)wo::wgmma_dtype<__nv_bfloat16>(x, w, scale, bias, y, part,
                                               M, N, K, gs, bn, kper, s);
  if (dtype == wo::kF16)
    return (int)wo::wgmma_dtype<__half>(x, w, scale, bias, y, part, M, N, K,
                                        gs, bn, kper, s);
  return (int)cudaErrorInvalidValue;
}

// The sizes the wrapper's plans rest on, and the routes' dynamic shared
// memory (phase 2's report).
extern "C" int wo_mma_rows() { return wo::kMmaRows; }
extern "C" int wo_mma_step() { return wo::kMmaStep; }
extern "C" int wo_mma_max_split() { return wo::kMmaMaxSplit; }
extern "C" int wo_wgmma_rows() { return wo::wg::kBM; }
extern "C" int wo_mma_smem(int m, int ksplit) {
  return (int)(m <= 8 ? wo::mma_smem<1>(ksplit) : wo::mma_smem<2>(ksplit));
}
extern "C" int wo_wgmma_smem(int bn) {
  return bn == 64    ? (int)wo::wg::Layout<64>::kSmem
         : bn == 128 ? (int)wo::wg::Layout<128>::kSmem
                     : (int)wo::wg::Layout<256>::kSmem;
}
