// Hopper tile layer (sm_90a): warpgroup products fed by a ring of tiles
// that the Tensor Memory Accelerator copies into shared memory. Used by the
// bf16 routes of the fused CE forward and backward (fused_cross_entropy.cu,
// TPU kernels #11 and #12, one mainloop), the single-block flash forward
// (flash_attention.cu, #5), the online-softmax forward of the tiled flash
// and splash kernels (attention_wgmma.cuh, #7 and #9), the flash and
// splash backwards (attention_wgmma_bwd.cuh, #6, #8 and #10) and the chunk
// attention over paged pools (paged_wgmma.cuh, #3 and #4, whose rows are
// copied by threads with cp.async, not by TMA) and the weight-only linear's
// prompt route (weight_only.cu, bf16 and fp16 x: an int8 tile by TMA,
// dequantized by threads into a swizzled panel). The split-K decode
// (paged_split.cuh, #1 and #2) takes only its mbarriers and 1-D bulk
// copies (`load_1d`) and does its math on CUDA cores. The fp32 routes stay
// on tile_mma.cuh or paged_attention.cu's CUDA-core body (wgmma has no
// true-fp32 form and TF32 is off by the port's numerics contract).
//
// What it offers, and each helper's contract:
//   * Swizzled panels. Every operand tile lives in shared memory as
//     panels of rows of 128 bytes (64 bf16), with the 16-byte chunk c of
//     row r stored at chunk c ^ (r % 8) (the 128-byte swizzle). A panel
//     starts on a 1024-byte boundary. TMA writes exactly this image for a
//     box whose inner extent is 64 elements (`make_map`, `load_2d`,
//     `load_4d`; `make_map_of` for another element type or swizzle);
//     `sw128` gives the byte offset of an element in it.
//     `load_1d` copies contiguous bytes with no map and no swizzle.
//   * Descriptors (`desc`). A K-major operand (K contiguous, the rows are
//     M or N) is one panel per 64 columns of K: a k16 step starts 32 bytes
//     further along the row, SBO = 1024 (the next 8 rows), LBO unused. An
//     MN-major operand (M or N contiguous, the rows are K) is one panel per
//     64 columns of M or N: a k16 step starts 16 rows (2048 bytes) further
//     down, SBO = 1024 (the next 8 K rows), LBO = the panel size (the next
//     64 columns of M or N). 16-bit types take both majors, so no operand
//     is transposed in memory.
//   * Warpgroup products. `mma_ss<N, tA, tB>`: D[64 x N] (+)= A . B, A and
//     B from descriptors (`mma_ss<N, tA, tB, true>`: fp16 operands, the
//     .f16 form); `mma_rs<N, tB>`: A from registers. bf16 x bf16 -> fp32,
//     m64nNk16, N in {64, 128, 256} (the widths these kernels use;
//     another width is one more instantiation of the same pattern).
//     `fence()` before a batch (the accumulators or A registers were
//     written by other instructions), `commit()` after it, `wait<n>()`
//     until at most n batches are in flight; `fence_regs` keeps the
//     compiler from moving register accesses across the asynchronous
//     product.
//   * The accumulator fragment. Thread t of the warpgroup holds, for
//     i = 4j + e, the element (row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2),
//     column 8 j + 2 (t % 4) + e % 2) (`acc_row`, `acc_col`): a quad of
//     lanes shares a row (`quad_max`, `quad_sum`). `pack_a` turns 16
//     columns of such an fp32 fragment into the four bf16x2 A registers of
//     an RS product: the accumulator layout is the A layout.
//   * Product batches (`issue_ss`, `issue_rs`: a whole k loop, fenced and
//     committed) and the named barriers over the two consumer warpgroups
//     (`named_sync`, `named_arrive`).
//   * Copies by threads (`cp_async`, 16, 8 or 4 bytes, zero-filling when
//     told to): what a thread writes to shared memory reaches the products
//     (the async proxy) only after its `fence_async_smem`, which comes
//     before the arrival on the consumers' barrier.
//   * The ring (`Ring`): stages of tiles, a "full" mbarrier (one arrival
//     with the copy's transaction bytes) and an "empty" mbarrier (every
//     consumer thread arrives when its products have read the stage) per
//     stage. One producer thread waits for an empty stage, sets the bytes
//     it expects and issues the TMA copies; the consumers wait for a full
//     stage. The producer runs `stages` tiles ahead, so copies overlap the
//     products.
//
// Copies are TMA (cp.async.bulk.tensor): one thread moves a whole tile, the
// hardware zero-fills the rows and columns past a tensor's edge (ragged
// tiles need no masking on the load side), and a strided view is a tensor
// map over its own strides (q/k/v stay views of the packed qkv). Tensor
// maps are encoded on the host through cudaGetDriverEntryPoint, so the
// plain-C library needs no -lcuda, and reach the kernel as
// __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hop {

constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kRowBytes = 128;      // a swizzled row: 64 bf16

// ---------------------------------------------------------------------------
// shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to a 1024-byte boundary (the
// launcher requests 1024 bytes more than the layout needs).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// Byte offset of element `col` (0..63) of row r in a swizzled panel.
__device__ __forceinline__ uint32_t sw128(int r, int col) {
  return r * kRowBytes + ((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) << 1));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// After the inits, before any other thread uses the barriers (then a
// __syncthreads).
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// One arrival that also expects `bytes` of asynchronous copies.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Until the phase of parity `parity` has completed (a fresh barrier counts
// the phase before it, of parity 1, as completed). A wait that spins 2^24
// times traps: a lost copy or a miscounted barrier is a launch error, not
// a hung card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}

// Stage and phase of a ring of `stages` slots. The producer starts with
// phase 1 (every slot empty), the consumers with phase 0.
struct Ring {
  int stage, phase, stages;
  __device__ Ring(int n, int start_phase) : stage(0), phase(start_phase),
                                            stages(n) {}
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void load_4d(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1, int c2,
                                        int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 1-D bulk copy of `bytes` contiguous bytes (a whole pool page of the
// paged decode, paged_split.cuh): src, dst and bytes multiples of 16. No
// tensor map and no swizzle; the transaction bytes count toward `bar`'s
// complete_tx like a tile's.
__device__ __forceinline__ void load_1d(void* dst, const void* src,
                                        uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A tensor map of `elem_bytes`-byte elements of `type`: dims[0] is the
// contiguous dimension; strides[i] is dimension i + 1's stride in
// elements; box[i] the tile's extent. Elements past dims read as zeros.
inline cudaError_t make_map_of(CUtensorMap* map, const void* base, int rank,
                               const long long* dims,
                               const long long* strides, const int* box,
                               CUtensorMapDataType type, int elem_bytes,
                               CUtensorMapSwizzle swizzle) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess ? (Encode)fn : nullptr;
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    e[i] = 1;
    if (i) s[i - 1] = (cuuint64_t)strides[i - 1] * elem_bytes;
  }
  const CUresult r = encode(
      map, type, (cuuint32_t)rank, const_cast<void*>(base), d, s, b, e,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 tensor map with the 128-byte swizzle: box[0] is 64 (one
// swizzled row).
inline cudaError_t make_map(CUtensorMap* map, const void* base, int rank,
                            const long long* dims, const long long* strides,
                            const int* box) {
  return make_map_of(map, base, rank, dims, strides, box,
                     CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------------------
// warpgroup products
// ---------------------------------------------------------------------------

// A shared-memory matrix descriptor with the 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kInFlight>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kInFlight)
               : "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOP_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOP_D32(i) HOP_D8(i), HOP_D8(i + 8), HOP_D8(i + 16), HOP_D8(i + 24)
#define HOP_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOP_REGS64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define HOP_REGS128                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// D[64 x N] = (scale_d ? D : 0) + A . B over one k16 step; kTA / kTB: A /
// B MN-major; kF16: fp16 operands (the .f16 form), else bf16.
#define HOP_SS(W, AB, REGS, DA, DB, SC, TA, TB)                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n"          \
               "wgmma.mma_async.sync.aligned.m64n" #W "k16.f32." AB "." AB \
               " " REGS ", " DA ", " DB ", p, 1, 1, " TA ", " TB ";\n}\n"
template <int N, int kTA, int kTB, bool kF16 = false>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma width");
  if constexpr (N == 64) {
    if constexpr (kF16)
      HOP_SS(64, "f16", HOP_REGS32, "%32", "%33", "%34", "%35", "%36")
          : HOP_D32(0)
          : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
    else
      HOP_SS(64, "bf16", HOP_REGS32, "%32", "%33", "%34", "%35", "%36")
          : HOP_D32(0)
          : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
  } else if constexpr (N == 128) {
    if constexpr (kF16)
      HOP_SS(128, "f16", HOP_REGS64, "%64", "%65", "%66", "%67", "%68")
          : HOP_D32(0), HOP_D32(32)
          : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
    else
      HOP_SS(128, "bf16", HOP_REGS64, "%64", "%65", "%66", "%67", "%68")
          : HOP_D32(0), HOP_D32(32)
          : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
  } else {
    if constexpr (kF16)
      HOP_SS(256, "f16", HOP_REGS128, "%128", "%129", "%130", "%131", "%132")
          : HOP_D32(0), HOP_D32(32), HOP_D32(64), HOP_D32(96)
          : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
    else
      HOP_SS(256, "bf16", HOP_REGS128, "%128", "%129", "%130", "%131", "%132")
          : HOP_D32(0), HOP_D32(32), HOP_D32(64), HOP_D32(96)
          : "l"(da), "l"(db), "r"(scale_d), "n"(kTA), "n"(kTB));
  }
}
#undef HOP_SS

// The same with A[64 x 16] from registers (`pack_a`).
template <int N, int kTB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma width");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOP_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HOP_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(kTB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOP_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : HOP_D32(0), HOP_D32(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d), "n"(kTB));
  }
}

#undef HOP_D8
#undef HOP_D32
#undef HOP_REGS32
#undef HOP_REGS64
#undef HOP_REGS128

// ---------------------------------------------------------------------------
// the accumulator fragment
// ---------------------------------------------------------------------------

// Row (0..63) and column of accumulator element i of thread t (0..127).
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns [16 kk, 16 kk + 16) of an fp32 fragment as the A registers of an
// RS product (rounded to nearest even).
template <int R>
__device__ __forceinline__ void pack_a(const float (&p)[R], int kk,
                                       uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = pack_bf16(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1]);
}

// ---------------------------------------------------------------------------
// product batches and consumer barriers
// ---------------------------------------------------------------------------

// acc[64 x N] = A B^T over D: A (64 rows) and B (N rows) K-major, their
// panels of 64 columns a_panel / b_panel bytes apart (S = Q K^T: both
// panels of 128 rows).
template <int N, int D>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a,
                                         uint32_t a_panel, uint32_t b,
                                         uint32_t b_panel) {
  fence_regs(acc);
  fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t c = (kk & 3) * 32;
    mma_ss<N, 0, 0>(acc, desc(a + (kk >> 2) * a_panel + c, 16, 1024),
                    desc(b + (kk >> 2) * b_panel + c, 16, 1024), kk > 0);
  }
  commit();
}

// acc[64 x N] += A B: A[64 x K] from the A registers, B [K rows x N]
// MN-major, its panels of 64 columns b_panel bytes apart (O += P V).
template <int N, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[N / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         uint32_t b, uint32_t b_panel) {
  fence_regs(acc);
  fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    mma_rs<N, 1>(acc, a[kk], desc(b + kk * 16 * kRowBytes, b_panel, 1024),
                 1);
  commit();
}

// Keeps A registers live until the product that reads them has been
// waited for (the compiler does not know the product reads them late).
template <int K>
__device__ __forceinline__ void fence_a(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// Named barriers over the two consumer warpgroups (id 1 and 2: the
// ping-pong's turns; 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kConsumers)
               : "memory");
}

// setmaxnreg: a warpgroup's registers a thread, raised or lowered.
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// ---------------------------------------------------------------------------
// copies by threads
// ---------------------------------------------------------------------------

// cp.async of `bytes` (4, 8 or 16) from global to shared memory; with
// `fill` false the destination gets zeros and nothing is read.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool fill) {
  const uint32_t d = smem_addr(dst);
  const uint32_t n = fill ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Until at most n of this thread's cp.async groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// Orders this thread's shared-memory writes (plain stores, completed
// cp.async copies) before the products' reads of them (the async
// proxy); then the thread arrives on the barrier the consumers wait on.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Opt a kernel into its dynamic shared memory.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace hop
