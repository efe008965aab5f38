// Vocab-tiled fused LM-head cross entropy for Hopper (sm_90a), forward and
// backward: the [N, V] logits and d_logits never exist in device memory.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused_cross_entropy.py:
//   bf16: fused_ce_fwd_wgmma_kernel
//   fp32: fused_ce_fwd_kernel
//         (+ fused_ce_combine_kernel)               <- _fwd_kernel (via
//                                                        _fwd_pallas)
//   bf16: fused_ce_bwd_wgmma_kernel<0, 1, 2>
//   fp32: fused_ce_dh_kernel, fused_ce_dw_kernel
//         (+ fused_ce_cast_kernel)                  <- _bwd_kernel (via
//                                                        _bwd_call)
// The plain PyTorch versions (fused_ce_fwd_ref / fused_ce_bwd_ref in
// ops/kernels/fused_cross_entropy.py, transcriptions of _fwd_xla/_bwd_xla)
// define the contract and these kernels follow their arithmetic: fp32
// logits from products with fp32 accumulation, an online logsumexp over the
// vocab tiles, the label logit picked by an exact column match (so a column
// past the vocab, masked to -inf, never matches), loss = lse - picked (0 at
// ignore_index); backward d = (exp(logit - lse) - onehot) * g_eff, cast to
// the hidden dtype before both products, fp32 sums, dh and dW cast to their
// dtypes at the end.
//
// Layouts: hidden [N, H], weight [V, H] (fp32 or bf16, contiguous), labels
// [N] int32, g_eff [N] fp32 (the loss cotangent, 0 on ignored rows); loss,
// lse [N] fp32; dh [N, H], dW [V, H]. Scratch the wrapper allocates: the
// forward's per-split (m, l, picked) [3, S, N] (bf16: S = ceil(V / 256),
// one a vocab tile); the bf16 backward's d chunk
// [N, Vc] bf16 and, with more than one chunk, dh32 [N, H] fp32; the fp32
// backward's dh32 [S, Np, H] and dw32 [Vp, H] (Np, Vp: N and V rounded up
// to a tile; S vocab splits).
//
// The fp32 forward and backward: 256 threads (8 warps) a block; the
// logits of a tile of 64 tokens x 128 vocab rows are one product over the
// hidden axis, staged 128 columns at a time, in tile_mma.cuh (CUDA cores
// in fp32; the same kernels instantiated for bf16 run wmma on the tensor
// cores, each warp a 32 x 32 block of fp32 accumulators: the forward's
// first design, which chip_smoke.py times beside the bf16 route).
//   forward: a block per (64 tokens, split of the vocab tiles) folds its
//     tiles into a partial (m, l, picked); fused_ce_combine_kernel merges
//     the S partials of a token in split order. The wrapper picks S so the
//     grid fills the card once (two blocks an SM): one block per 64 tokens
//     alone is 128 blocks at N = 8192, under one for each of the 132 SMs.
//   fp32 backward, two kernels, each recomputing the logits tile from the
//     lse: the dh kernel (a block per (64 tokens, split of the vocab
//     tiles)) adds d . W_tile into its own rows of dh32[split], and the dW
//     kernel (a block per 128 vocab rows, walking all token tiles) adds
//     d^T . h_tile into its own rows of dw32; fused_ce_cast_kernel sums the
//     dh splits in order. The fp32 sums live in device memory and are read
//     and written once per step of a block's walk: at N 8192, H 2048, V
//     50304 about 50 GB for the dh kernel and 100 GB for the dW kernel.
//
// The bf16 routes share one warpgroup GEMM mainloop (`bw::mainloop`, on
// hopper_tiles.cuh: 128 x 256 output tiles, two consumer warpgroups of 64
// rows with fp32 accumulators in registers, one producer warp keeping a
// four-stage ring of 64-deep A and B tiles in flight by TMA) under four
// epilogues.
//
// The bf16 forward: one launch of the mainloop over h . W^T, grid (token
// tiles, vocab tiles of 256) with the token tiles fastest, so the blocks
// that read one W tile run together and W is read from device memory
// about once (h stays in L2); then fused_ce_combine_kernel. Its epilogue
// masks columns past the vocab to -inf, folds each row's 256 logits into
// (max, sum of exp(logit - max), picked) in registers (each thread its 64
// columns of two rows, then quad shuffles) and writes them to the
// [3, tiles, N] partials; the combine merges the tiles in order (no float
// atomics: bit-identical on a second run).
//
// The bf16 backward walks the vocab in chunks of Vc rows (the wrapper picks
// Vc, a multiple of 256, so the chunk's scratch stays within a fixed
// budget). For each chunk in order, three launches of the mainloop with
// three epilogues:
//   1. d chunk: D[N, Vc] = epilogue(h . W_c^T), both operands K-major; the
//      epilogue applies lse, label and g per row and stores d in bf16 (0
//      for rows past the vocab). The logits' only computation in the
//      backward: three products, as the bound counts.
//   2. dh: dh32 (+)= D . W_c (K = Vc; W_c is an MN-major B operand). An
//      output tile keeps its sums in registers over the chunk's whole K,
//      so dh32 is read and written once a chunk; the last chunk's epilogue
//      writes bf16 dh (one chunk: no dh32 at all).
//   3. dW: dW[chunk rows] = D^T . h (K = tokens; both operands MN-major). A
//      vocab row's whole sum over the tokens lives in one block's
//      registers, so bf16 dW is written once and no fp32 dW exists.
// Every output element is summed by one block in a fixed order and the
// chunks run in order: no atomics, so dh and dW are bit-reproducible.
// Only one chunk of d ever exists in device memory, never the [N, V]
// logits.
//
// What bounds it on the H100: operations. At the training shape (N 8192, H
// 2048, V 50304, bf16) the forward's product is 2 N V H = 1.69e12 flops
// (1.71 ms at 989 TFLOP/s) and the backward's three 5.07e12 (5.12 ms);
// the bytes (W 206 MB, h 34 MB; the d chunks add 2.5 GB written once and
// read twice, 0.74 ms) are under that. What the bf16 routes still leave
// on the table: no persistent walk (an output tile's epilogue, in the
// forward 128 exponentials a thread, does not overlap the next tile's
// loads; the last grids fill the card unevenly); the backward's d chunk
// round trip through device memory and 4-byte epilogue stores; the
// forward's partials (19 MB at the training shape) and a second launch
// for the combine.

#include "hopper_tiles.cuh"
#include "tile_mma.cuh"

namespace {

using tile::from_f;

constexpr int kNT = 256;      // threads a block
constexpr int kRows = 64;     // tokens of a logits tile
constexpr int kV = 128;       // vocab rows of a logits tile
constexpr int kChunk = 128;   // hidden columns staged at a time

// Shared memory of every kernel: the staged X (tokens) and Y (vocab)
// chunks, the fp32 logits tile, d (T), and per-token lse, g, label (and
// the forward's running m, l, picked).
template <typename T>
struct Smem {
  T* x;        // [kRows][pc]   token rows
  T* y;        // [kV][pc]      vocab rows
  float* s;    // [kRows][ps]   logits
  T* d;        // [kRows][pd]   (softmax - onehot) * g
  float* tok;  // [5][kRows]    lse, g, m, l, picked
  int* lbl;    // [kRows]
  static constexpr int pc = tile::pitch<T>(kChunk);
  static constexpr int ps = kV + 4;
  static constexpr int pd = tile::pitch<T>(kV);

  __host__ __device__ static size_t bytes() {
    size_t off = 0;
    tile::take(off, (kRows + kV) * pc * sizeof(T));
    tile::take(off, kRows * ps * sizeof(float));
    tile::take(off, kRows * pd * sizeof(T));
    tile::take(off, 5 * kRows * sizeof(float));
    tile::take(off, kRows * sizeof(int));
    return off;
  }

  __device__ explicit Smem(unsigned char* base) {
    size_t off = 0;
    x = (T*)(base + tile::take(off, (kRows + kV) * pc * sizeof(T)));
    y = x + kRows * pc;
    s = (float*)(base + tile::take(off, kRows * ps * sizeof(float)));
    d = (T*)(base + tile::take(off, kRows * pd * sizeof(T)));
    tok = (float*)(base + tile::take(off, 5 * kRows * sizeof(float)));
    lbl = (int*)(base + tile::take(off, kRows * sizeof(int)));
  }
};

// s[64 x 128] = h[t0 : t0+64] . w[v0 : v0+128]^T over the hidden axis, in
// fp32 (rows past n and vocab rows past `vocab` staged as zeros).
template <typename T>
__device__ void logits_tile(const Smem<T>& sm, const T* h, const T* w,
                            int t0, int n, int v0, int vocab, int hidden) {
  const int tr = min(kRows, n - t0), vr = min(kV, vocab - v0);
  for (int c0 = 0; c0 < hidden; c0 += kChunk) {
    const int kc = min(kChunk, hidden - c0);
    __syncthreads();   // the last product (or the reads of s) is done
    tile::stage<T, kNT>(sm.x, sm.pc, h + (size_t)t0 * hidden + c0, hidden,
                        kRows, tr, kc);
    tile::stage<T, kNT>(sm.y, sm.pc, w + (size_t)v0 * hidden + c0, hidden,
                        kV, vr, kc);
    __syncthreads();
    tile::mma<T, false, true, kNT>(sm.s, sm.ps, sm.x, sm.pc, sm.y, sm.pc,
                                   kRows, kV, kc, c0 > 0);
  }
  __syncthreads();
}

// The lse, g_eff and label of tokens [t0, t0 + 64) into sm.tok / sm.lbl;
// tokens past n get g = 0, so they never contribute.
template <typename T>
__device__ void stage_tokens(const Smem<T>& sm, const int* labels,
                             const float* lse, const float* g_eff, int t0,
                             int n) {
  if (threadIdx.x < kRows) {
    const int t = t0 + threadIdx.x;
    const bool in = t < n;
    sm.tok[threadIdx.x] = in ? lse[t] : 0.f;
    sm.tok[kRows + threadIdx.x] = in ? g_eff[t] : 0.f;
    sm.lbl[threadIdx.x] = in ? labels[t] : -1;
  }
}

// d = (exp(s - lse) - onehot) * g into sm.d, in T, from the logits tile.
template <typename T>
__device__ void d_tile(const Smem<T>& sm, int v0, int vocab) {
  for (int idx = threadIdx.x; idx < kRows * kV; idx += kNT) {
    const int r = idx / kV, j = idx - r * kV;
    const int v = v0 + j;
    float dv = 0.f;
    if (v < vocab)
      dv = (expf(sm.s[r * sm.ps + j] - sm.tok[r]) -
            (sm.lbl[r] == v ? 1.f : 0.f)) * sm.tok[kRows + r];
    sm.d[r * sm.pd + j] = from_f<T>(dv);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// A block per (64 tokens, split): (m, l, picked) over the split's vocab
// tiles into part[0 / 1 / 2][split][token].
template <typename T>
__global__ void __launch_bounds__(kNT) fused_ce_fwd_kernel(
    const T* __restrict__ h, const T* __restrict__ w,
    const int* __restrict__ labels, float* __restrict__ part, int n,
    int vocab, int hidden, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> sm(smem);
  const int t0 = blockIdx.x * kRows, split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* m_s = sm.tok + 2 * kRows;
  float* l_s = sm.tok + 3 * kRows;
  float* pk_s = sm.tok + 4 * kRows;
  if (tid < kRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    pk_s[tid] = 0.f;
    sm.lbl[tid] = t0 + tid < n ? labels[t0 + tid] : -1;
  }
  const int v_begin = split * tiles_per_split * kV;
  const int v_end = min(vocab, v_begin + tiles_per_split * kV);
  for (int v0 = v_begin; v0 < v_end; v0 += kV) {
    logits_tile(sm, h, w, t0, n, v0, vocab, hidden);
    // online logsumexp + picked label logit: one warp per row, 4 columns
    // a lane; every tile holds a real column, so m_new is finite
    for (int r = warp; r < kRows; r += kNT / 32) {
      float x[4], pick = 0.f, mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = v0 + lane + 32 * e;
        x[e] = col < vocab ? sm.s[r * sm.ps + lane + 32 * e] : -INFINITY;
        if (col == sm.lbl[r]) pick = x[e];
        mx = fmaxf(mx, x[e]);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, tile::warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) sum += expf(x[e] - m_new);
      sum = tile::warp_sum(sum);
      pick = tile::warp_sum(pick);
      if (lane == 0) {
        l_s[r] = expf(m_prev - m_new) * l_s[r] + sum;
        m_s[r] = m_new;
        pk_s[r] += pick;
      }
    }
  }
  __syncthreads();
  if (tid < kRows && t0 + tid < n) {
    const size_t plane = (size_t)gridDim.y * n;
    const size_t at = (size_t)split * n + t0 + tid;
    part[at] = m_s[tid];
    part[plane + at] = l_s[tid];
    part[2 * plane + at] = pk_s[tid];
  }
}

// One thread per token: merge the S partials in split order. `picked`
// (may be null) gets the label's logit beside lse: the vocab-parallel
// head combines (lse, picked) across ranks, and lse - loss would cancel.
__global__ void fused_ce_combine_kernel(const float* __restrict__ part,
                                        const int* __restrict__ labels,
                                        float* __restrict__ loss,
                                        float* __restrict__ lse,
                                        float* __restrict__ picked, int n,
                                        int splits, int ignore_index) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const size_t plane = (size_t)splits * n;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, part[(size_t)s * n + t]);
  float l = 0.f, pk = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t at = (size_t)s * n + t;
    l += expf(part[at] - m) * part[plane + at];
    pk += part[2 * plane + at];
  }
  const float z = m + logf(l);
  lse[t] = z;
  loss[t] = labels[t] != ignore_index ? z - pk : 0.f;
  if (picked != nullptr) picked[t] = pk;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// A block per (64 tokens, split): dh32[split][t0 : t0+64] += d . W_tile
// for every vocab tile of the split, in order.
template <typename T>
__global__ void __launch_bounds__(kNT) fused_ce_dh_kernel(
    const T* __restrict__ h, const T* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ g_eff, float* __restrict__ dh32, int n,
    int n_pad, int vocab, int hidden, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> sm(smem);
  const int t0 = blockIdx.x * kRows, split = blockIdx.y;
  float* acc = dh32 + ((size_t)split * n_pad + t0) * hidden;
  stage_tokens(sm, labels, lse, g_eff, t0, n);
  const int v_begin = split * tiles_per_split * kV;
  const int v_end = min(vocab, v_begin + tiles_per_split * kV);
  for (int v0 = v_begin; v0 < v_end; v0 += kV) {
    logits_tile(sm, h, w, t0, n, v0, vocab, hidden);
    d_tile(sm, v0, vocab);
    const int vr = min(kV, vocab - v0);
    for (int c0 = 0; c0 < hidden; c0 += kChunk) {
      const int kc = min(kChunk, hidden - c0);
      __syncthreads();   // d is complete; the last chunk's product is done
      tile::stage<T, kNT>(sm.y, sm.pc, w + (size_t)v0 * hidden + c0, hidden,
                          kV, vr, kc);
      __syncthreads();
      tile::mma<T, false, false, kNT>(acc + c0, hidden, sm.d, sm.pd, sm.y,
                                      sm.pc, kRows, kc, kV, v0 > v_begin);
    }
  }
}

// A block per 128 vocab rows: dw32[v0 : v0+128] += d^T . h_tile for every
// token tile, in order.
template <typename T>
__global__ void __launch_bounds__(kNT) fused_ce_dw_kernel(
    const T* __restrict__ h, const T* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ g_eff, float* __restrict__ dw32, int n,
    int vocab, int hidden) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<T> sm(smem);
  const int v0 = blockIdx.x * kV;
  float* acc = dw32 + (size_t)v0 * hidden;
  for (int t0 = 0; t0 < n; t0 += kRows) {
    __syncthreads();   // the last tile's reads of the token stats are done
    stage_tokens(sm, labels, lse, g_eff, t0, n);
    logits_tile(sm, h, w, t0, n, v0, vocab, hidden);
    d_tile(sm, v0, vocab);
    const int tr = min(kRows, n - t0);
    for (int c0 = 0; c0 < hidden; c0 += kChunk) {
      const int kc = min(kChunk, hidden - c0);
      __syncthreads();
      tile::stage<T, kNT>(sm.x, sm.pc, h + (size_t)t0 * hidden + c0, hidden,
                          kRows, tr, kc);
      __syncthreads();
      tile::mma<T, true, false, kNT>(acc + c0, hidden, sm.d, sm.pd, sm.x,
                                     sm.pc, kV, kc, kRows, t0 > 0);
    }
  }
}

// out[r][c] = sum over s in order of src[s][r][c] (planes `plane` apart),
// cast to T: the dh splits, or dw32 with one plane.
template <typename T>
__global__ void fused_ce_cast_kernel(const float* __restrict__ src,
                                     T* __restrict__ out, long long count,
                                     long long plane, int planes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = src[i];
  for (int s = 1; s < planes; ++s) v += src[s * plane + i];
  out[i] = from_f<T>(v);
}

// ---------------------------------------------------------------------------
// backward, bf16: one warpgroup GEMM with three epilogues, chunk by chunk
// ---------------------------------------------------------------------------

namespace bw {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kABytes = kBM * kBK * 2;                  // 16 KB
constexpr int kBBytes = kBN * kBK * 2;                  // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kMnPanel = kBK * hop::kRowBytes;          // 64 K rows, 8 KB
constexpr size_t kSmem = (size_t)kStages * kStageBytes + 2 * kStages * 8 +
                         1024;

// One chunk's launch: the tensors, and vocab rows [v0, v0 + rows).
struct Args {
  const int* labels;
  const float* lse;
  const float* g;
  __nv_bfloat16* dchunk;     // [n, width]
  float* dh32;               // [n, hidden], with more than one chunk
  __nv_bfloat16* dh;
  __nv_bfloat16* dw;
  int n, vocab, hidden, width;
  int v0, rows, first, last;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The mainloop every warpgroup GEMM of this file shares: a 128 x 256
// output tile at (m0, n0), K walked 64 at a time through the ring. The
// producer warp starts the TMA copies and returns false; the two consumer
// warpgroups run the products into `acc` (warpgroup wg owns output rows
// [m0 + 64 wg, m0 + 64 wg + 64)) and return true. kKind picks the
// operands' majors and the copies' coordinates:
//   kKind 0, logits: h . W^T (rows v0 + n0 on of W); A = h, B = W, both
//     K-major (the backward's d chunk, and the forward with v0 = 0).
//   kKind 1, dh: A = D (K-major), B = W_c (MN-major, K rows from v0).
//   kKind 2, dW: A = D, B = h, both MN-major.
// Operand tiles past a tensor's edge arrive as zeros (TMA), so only the
// epilogues mask.
template <int kKind>
__device__ __forceinline__ bool mainloop(const CUtensorMap* ta,
                                         const CUtensorMap* tb, int v0,
                                         int m0, int n0, int k_steps,
                                         unsigned char* sm,
                                         float (&acc)[kBN / 2]) {
  constexpr int kAMn = kKind == 2, kBMn = kKind != 0;
  uint64_t* full = (uint64_t*)(sm + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::bar_init(&full[s], 1);
      hop::bar_init(&empty[s], hop::kConsumers);
    }
    hop::bar_fence_init();
  }
  __syncthreads();

  if (tid >= hop::kConsumers) {
    if (tid == hop::kConsumers) {   // producer
      hop::Ring ring(kStages, 1);
      for (int ks = 0; ks < k_steps; ++ks, ring.advance()) {
        hop::bar_wait(&empty[ring.stage], ring.phase);
        uint64_t* bar = &full[ring.stage];
        hop::bar_arrive_tx(bar, kStageBytes);
        unsigned char* sa = sm + ring.stage * kStageBytes;
        unsigned char* sb = sa + kABytes;
        const int k0 = ks * kBK;
        if (kKind == 0) {
          hop::load_2d(sa, ta, bar, k0, m0);
          hop::load_2d(sb, tb, bar, k0, v0 + n0);
        } else if (kKind == 1) {
          hop::load_2d(sa, ta, bar, k0, m0);
          for (int p = 0; p < kBN / 64; ++p)
            hop::load_2d(sb + p * kMnPanel, tb, bar, n0 + 64 * p, v0 + k0);
        } else {
          for (int p = 0; p < kBM / 64; ++p)
            hop::load_2d(sa + p * kMnPanel, ta, bar, m0 + 64 * p, k0);
          for (int p = 0; p < kBN / 64; ++p)
            hop::load_2d(sb + p * kMnPanel, tb, bar, n0 + 64 * p, k0);
        }
      }
    }
    return false;
  }

  const int wg = tid >> 7;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  hop::fence_regs(acc);
  const uint32_t base = hop::smem_addr(sm);
  hop::Ring ring(kStages, 0);
  int held = -1;   // the stage the batch in flight reads
  for (int ks = 0; ks < k_steps; ++ks, ring.advance()) {
    hop::bar_wait(&full[ring.stage], ring.phase);
    // A: rows 64 wg of a K-major tile, or panel wg of an MN-major one
    const uint32_t sa = base + ring.stage * kStageBytes + wg * 64 * 128;
    const uint32_t sb = base + ring.stage * kStageBytes + kABytes;
    hop::fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = kAMn ? hop::desc(sa + kk * 2048, kMnPanel, 1024)
                               : hop::desc(sa + kk * 32, 16, 1024);
      const uint64_t db = kBMn ? hop::desc(sb + kk * 2048, kMnPanel, 1024)
                               : hop::desc(sb + kk * 32, 16, 1024);
      hop::mma_ss<kBN, kAMn, kBMn>(acc, da, db, 1);
    }
    hop::commit();
    hop::wait<1>();   // the previous step's batch is done: free its stage
    hop::fence_regs(acc);
    if (held >= 0) hop::bar_arrive(&empty[held]);
    held = ring.stage;
  }
  hop::wait<0>();
  hop::fence_regs(acc);
  return true;
}

}  // namespace bw

// The backward's three kinds on the shared mainloop:
//   kKind 0, the d chunk: D[tokens, chunk] = epilogue(h . W_c^T); grid
//     (token tiles, chunk tiles).
//   kKind 1, dh: dh32 (+)= D . W_c; grid (hidden tiles, token tiles), so
//     the blocks that share a row panel of D run together.
//   kKind 2, dW: dW[chunk rows] = D^T . h; grid (hidden tiles, chunk
//     tiles).
template <int kKind>
__global__ void __launch_bounds__(hop::kThreads, 1) fused_ce_bwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap ta,
    const __grid_constant__ CUtensorMap tb, bw::Args a, int k_steps) {
  using namespace bw;
  extern __shared__ unsigned char smem_raw[];
  const int m0 = (kKind == 0 ? blockIdx.x : blockIdx.y) * kBM;
  const int n0 = (kKind == 0 ? blockIdx.y : blockIdx.x) * kBN;
  float acc[kBN / 2];
  if (!mainloop<kKind>(&ta, &tb, a.v0, m0, n0, k_steps,
                       hop::align1024(smem_raw), acc))
    return;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int r0 = m0 + 64 * wg + hop::acc_row(t, 0);   // and r0 + 8
  if (kKind == 0) {
    // d = (exp(logit - lse) - onehot) * g in bf16; 0 past the vocab
    float lse[2], g[2];
    int lbl[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * e;
      const bool in = r < a.n;
      lse[e] = in ? a.lse[r] : 0.f;
      g[e] = in ? a.g[r] : 0.f;
      lbl[e] = in ? a.labels[r] : -1;
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int e = (i >> 1) & 1, r = r0 + 8 * e;
      const int c = n0 + hop::acc_col(t, i), v = a.v0 + c;
      const float d0 = v < a.vocab ? (__expf(acc[i] - lse[e]) -
                                      (lbl[e] == v ? 1.f : 0.f)) * g[e]
                                   : 0.f;
      const float d1 = v + 1 < a.vocab
                           ? (__expf(acc[i + 1] - lse[e]) -
                              (lbl[e] == v + 1 ? 1.f : 0.f)) * g[e]
                           : 0.f;
      if (r < a.n)
        *reinterpret_cast<__nv_bfloat162*>(a.dchunk + (size_t)r * a.width +
                                           c) = __floats2bfloat162_rn(d0, d1);
    }
  } else if (kKind == 1) {
    // dh32 (+)= the chunk's sums; the last chunk writes bf16 dh
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int r = r0 + 8 * ((i >> 1) & 1), c = n0 + hop::acc_col(t, i);
      if (r >= a.n || c >= a.hidden) continue;
      const size_t at = (size_t)r * a.hidden + c;
      float2 v = make_float2(acc[i], acc[i + 1]);
      if (!a.first) {
        const float2 p = *reinterpret_cast<const float2*>(a.dh32 + at);
        v.x = p.x + v.x;
        v.y = p.y + v.y;
      }
      if (a.last)
        *reinterpret_cast<__nv_bfloat162*>(a.dh + at) =
            __floats2bfloat162_rn(v.x, v.y);
      else
        *reinterpret_cast<float2*>(a.dh32 + at) = v;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBN / 2; i += 2) {
      const int r = r0 + 8 * ((i >> 1) & 1), c = n0 + hop::acc_col(t, i);
      if (r < a.rows && c < a.hidden)
        *reinterpret_cast<__nv_bfloat162*>(
            a.dw + (size_t)(a.v0 + r) * a.hidden + c) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// The bf16 forward on the shared mainloop (kind 0's operands, v0 = 0): a
// 128 x 256 logits tile a block, grid (token tiles, vocab tiles) with the
// token tiles fastest, so the blocks that read one W tile run together and
// W is read from device memory about once (h, 34 MB at the training
// shape, stays in L2). The epilogue folds the tile into one partial a row:
// columns at v >= vocab are -inf (their W rows arrived as zeros, and a zero
// logit must not enter the sum); each thread takes the max, sum of
// exp(logit - max) and the label's logit over its 64 columns of each of
// its two rows, then the row's quad reduces them. The label matches by
// column, padded columns of the plain version's 128-wide tiles included
// (they count as -inf there too); a label past those matches nothing. The
// quad's first lane writes (m, l, picked) to part[0 / 1 / 2][tile][row],
// and fused_ce_combine_kernel merges the tiles in order.
__global__ void __launch_bounds__(hop::kThreads, 1) fused_ce_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap th,
    const __grid_constant__ CUtensorMap tw, const int* __restrict__ labels,
    float* __restrict__ part, int n, int vocab, int k_steps) {
  using namespace bw;
  extern __shared__ unsigned char smem_raw[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[kBN / 2];
  if (!mainloop<0>(&th, &tw, 0, m0, n0, k_steps, hop::align1024(smem_raw),
                   acc))
    return;
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int r0 = m0 + 64 * wg + hop::acc_row(t, 0);   // and r0 + 8
  const int v_pad = (vocab + 127) / 128 * 128;
  int lbl[2];
  float mx[2], sum[2], pick[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + 8 * e;
    lbl[e] = r < n ? labels[r] : -1;
    if (lbl[e] >= v_pad) lbl[e] = -1;
    mx[e] = -INFINITY;
    sum[e] = pick[e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int e = (i >> 1) & 1, v = n0 + hop::acc_col(t, i);
    if (v >= vocab) acc[i] = -INFINITY;
    mx[e] = fmaxf(mx[e], acc[i]);
    if (v == lbl[e]) pick[e] = acc[i];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) mx[e] = hop::quad_max(mx[e]);   // finite
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int e = (i >> 1) & 1;
    sum[e] += __expf(acc[i] - mx[e]);
  }
  const size_t plane = (size_t)gridDim.y * n;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    sum[e] = hop::quad_sum(sum[e]);
    pick[e] = hop::quad_sum(pick[e]);
    const int r = r0 + 8 * e;
    if ((t & 3) == 0 && r < n) {
      const size_t at = (size_t)blockIdx.y * n + r;
      part[at] = mx[e];
      part[plane + at] = sum[e];
      part[2 * plane + at] = pick[e];
    }
  }
}

// Parts of `count` tiles walked `per_split` at a time.
int splits_of(int count, int per_split) {
  return (count + per_split - 1) / per_split;
}

// The vocab splits are the forward's and dh kernel's grid y: at most 65535.
bool geometry_ok(int n, int vocab, int hidden, int tiles_per_split) {
  return n > 0 && vocab > 0 && hidden > 0 && hidden % 16 == 0 &&
         tiles_per_split > 0 &&
         splits_of((vocab + kV - 1) / kV, tiles_per_split) <= 65535;
}

template <typename T>
cudaError_t fwd(const void* h, const void* w, const int* labels, float* loss,
                float* lse, float* picked, float* part, int n, int vocab,
                int hidden, int ignore_index, int tiles_per_split,
                cudaStream_t stream) {
  const size_t smem = Smem<T>::bytes();
  cudaError_t err = tile::prepare(fused_ce_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int splits = splits_of((vocab + kV - 1) / kV, tiles_per_split);
  const dim3 grid((n + kRows - 1) / kRows, splits);
  fused_ce_fwd_kernel<T><<<grid, kNT, smem, stream>>>(
      (const T*)h, (const T*)w, labels, part, n, vocab, hidden,
      tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_ce_combine_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part, labels, loss, lse, picked, n, splits, ignore_index);
  return cudaGetLastError();
}

// The bf16 forward: two tensor maps (h and W, K-major), the logits tiles,
// then the combine over ceil(vocab / 256) tiles.
cudaError_t fwd_bf16(const void* h, const void* w, const int* labels,
                     float* loss, float* lse, float* picked, float* part,
                     int n, int vocab, int hidden, int ignore_index,
                     cudaStream_t stream) {
  using namespace bw;
  const long long h_dims[2] = {hidden, n}, w_dims[2] = {hidden, vocab};
  const long long stride[1] = {hidden};
  const int box_h[2] = {64, kBM}, box_w[2] = {64, kBN};
  CUtensorMap th, tw;
  cudaError_t err;
  if ((err = hop::make_map(&th, h, 2, h_dims, stride, box_h)) ||
      (err = hop::make_map(&tw, w, 2, w_dims, stride, box_w)) ||
      (err = hop::prepare(fused_ce_fwd_wgmma_kernel, kSmem)))
    return err;
  const int tiles = cdiv(vocab, kBN);
  fused_ce_fwd_wgmma_kernel<<<dim3(cdiv(n, kBM), tiles), hop::kThreads,
                              kSmem, stream>>>(th, tw, labels, part, n,
                                               vocab, cdiv(hidden, kBK));
  if ((err = cudaGetLastError())) return err;
  fused_ce_combine_kernel<<<cdiv(n, 256), 256, 0, stream>>>(
      part, labels, loss, lse, picked, n, tiles, ignore_index);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* h, const void* w, const int* labels,
                const float* lse, const float* g_eff, void* dh, void* dw,
                float* dh32, float* dw32, int n, int vocab, int hidden,
                int tiles_per_split, cudaStream_t stream) {
  const size_t smem = Smem<T>::bytes();
  cudaError_t err = tile::prepare(fused_ce_dh_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  err = tile::prepare(fused_ce_dw_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n + kRows - 1) / kRows, v_tiles = (vocab + kV - 1) / kV;
  const int n_pad = n_tiles * kRows;
  const int splits = splits_of(v_tiles, tiles_per_split);
  fused_ce_dh_kernel<T><<<dim3(n_tiles, splits), kNT, smem, stream>>>(
      (const T*)h, (const T*)w, labels, lse, g_eff, dh32, n, n_pad, vocab,
      hidden, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_ce_dw_kernel<T><<<v_tiles, kNT, smem, stream>>>(
      (const T*)h, (const T*)w, labels, lse, g_eff, dw32, n, vocab, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long dh_count = (long long)n * hidden;
  const long long dw_count = (long long)vocab * hidden;
  fused_ce_cast_kernel<T><<<(unsigned)((dh_count + 255) / 256), 256, 0,
                            stream>>>(dh32, (T*)dh, dh_count,
                                      (long long)n_pad * hidden, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_ce_cast_kernel<T><<<(unsigned)((dw_count + 255) / 256), 256, 0,
                            stream>>>(dw32, (T*)dw, dw_count, 0, 1);
  return cudaGetLastError();
}

// The bf16 backward: six tensor maps (h, W and the d chunk, each with the
// box its K-major and its MN-major use take), then three launches a chunk.
cudaError_t bwd_bf16(const void* h, const void* w, const int* labels,
                     const float* lse, const float* g_eff, void* dh, void* dw,
                     void* dchunk, float* dh32, int n, int vocab, int hidden,
                     int width, cudaStream_t stream) {
  using namespace bw;
  const long long h_dims[2] = {hidden, n}, w_dims[2] = {hidden, vocab};
  const long long d_dims[2] = {width, n};
  const long long h_stride[1] = {hidden}, d_stride[1] = {width};
  const int box_k[2] = {64, kBM}, box_w[2] = {64, kBN}, box_mn[2] = {64, kBK};
  CUtensorMap h_k, h_mn, w_k, w_mn, d_k, d_mn;
  cudaError_t err;
  if ((err = hop::make_map(&h_k, h, 2, h_dims, h_stride, box_k)) ||
      (err = hop::make_map(&h_mn, h, 2, h_dims, h_stride, box_mn)) ||
      (err = hop::make_map(&w_k, w, 2, w_dims, h_stride, box_w)) ||
      (err = hop::make_map(&w_mn, w, 2, w_dims, h_stride, box_mn)) ||
      (err = hop::make_map(&d_k, dchunk, 2, d_dims, d_stride, box_k)) ||
      (err = hop::make_map(&d_mn, dchunk, 2, d_dims, d_stride, box_mn)) ||
      (err = hop::prepare(fused_ce_bwd_wgmma_kernel<0>, kSmem)) ||
      (err = hop::prepare(fused_ce_bwd_wgmma_kernel<1>, kSmem)) ||
      (err = hop::prepare(fused_ce_bwd_wgmma_kernel<2>, kSmem)))
    return err;
  Args a{labels, lse, g_eff, (__nv_bfloat16*)dchunk, dh32,
         (__nv_bfloat16*)dh, (__nv_bfloat16*)dw, n, vocab, hidden, width,
         0, 0, 0, 0};
  for (int v0 = 0; v0 < vocab; v0 += width) {
    a.v0 = v0;
    a.rows = vocab - v0 < width ? vocab - v0 : width;
    a.first = v0 == 0;
    a.last = v0 + width >= vocab;
    fused_ce_bwd_wgmma_kernel<0>
        <<<dim3(cdiv(n, kBM), cdiv(a.rows, kBN)), hop::kThreads, kSmem,
           stream>>>(h_k, w_k, a, cdiv(hidden, kBK));
    fused_ce_bwd_wgmma_kernel<1>
        <<<dim3(cdiv(hidden, kBN), cdiv(n, kBM)), hop::kThreads, kSmem,
           stream>>>(d_k, w_mn, a, cdiv(a.rows, kBK));
    fused_ce_bwd_wgmma_kernel<2>
        <<<dim3(cdiv(hidden, kBN), cdiv(a.rows, kBM)), hop::kThreads, kSmem,
           stream>>>(d_mn, h_mn, a, cdiv(n, kBK));
    if ((err = cudaGetLastError())) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Plain C interface for ctypes. Each returns the cudaError_t of its
// launches (cudaErrorInvalidValue for a geometry the kernels do not take);
// nothing is allocated and nothing synchronises. `tiles_per_split`: vocab
// tiles of 128 a forward or dh block walks; the wrapper sizes the scratch
// for ceil(ceil(V / 128) / tiles_per_split) splits.
// `picked` (may be null): the label's logit a token, beside lse.
extern "C" int fused_ce_fwd(const void* h, const void* w, const void* labels,
                            void* loss, void* lse, void* picked, void* part,
                            int n, int vocab, int hidden, int ignore_index,
                            int tiles_per_split, int bf16, void* stream) {
  if (!geometry_ok(n, vocab, hidden, tiles_per_split))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)fwd<__nv_bfloat16>(h, w, (const int*)labels, (float*)loss,
                                   (float*)lse, (float*)picked, (float*)part,
                                   n, vocab, hidden, ignore_index,
                                   tiles_per_split, s);
  return (int)fwd<float>(h, w, (const int*)labels, (float*)loss, (float*)lse,
                         (float*)picked, (float*)part, n, vocab, hidden,
                         ignore_index, tiles_per_split, s);
}

// bf16 on warpgroup products: `part` holds [3, ceil(vocab / 256), n]
// fp32, the per-tile (m, l, picked) the combine merges.
extern "C" int fused_ce_fwd_bf16(const void* h, const void* w,
                                 const void* labels, void* loss, void* lse,
                                 void* picked, void* part, int n, int vocab,
                                 int hidden, int ignore_index, void* stream) {
  if (n <= 0 || vocab <= 0 || hidden <= 0 || hidden % 16 ||
      bw::cdiv(vocab, bw::kBN) > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)fwd_bf16(h, w, (const int*)labels, (float*)loss, (float*)lse,
                       (float*)picked, (float*)part, n, vocab, hidden,
                       ignore_index, (cudaStream_t)stream);
}

// fp32 only (bf16 takes fused_ce_bwd_bf16).
extern "C" int fused_ce_bwd(const void* h, const void* w, const void* labels,
                            const void* lse, const void* g_eff, void* dh,
                            void* dw, void* dh32, void* dw32, int n,
                            int vocab, int hidden, int tiles_per_split,
                            void* stream) {
  if (!geometry_ok(n, vocab, hidden, tiles_per_split))
    return (int)cudaErrorInvalidValue;
  return (int)bwd<float>(h, w, (const int*)labels, (const float*)lse,
                         (const float*)g_eff, dh, dw, (float*)dh32,
                         (float*)dw32, n, vocab, hidden, tiles_per_split,
                         (cudaStream_t)stream);
}

// bf16: `width` is the chunk's vocab rows (a multiple of 256); dchunk the
// [n, width] bf16 d chunk; dh32 the [n, hidden] fp32 sums of dh (unused,
// and may be null, when one chunk covers the vocab).
extern "C" int fused_ce_bwd_bf16(const void* h, const void* w,
                                 const void* labels, const void* lse,
                                 const void* g_eff, void* dh, void* dw,
                                 void* dchunk, void* dh32, int n, int vocab,
                                 int hidden, int width, void* stream) {
  if (n <= 0 || vocab <= 0 || hidden <= 0 || hidden % 16 || width <= 0 ||
      width % 256 || (dh32 == nullptr && width < vocab))
    return (int)cudaErrorInvalidValue;
  return (int)bwd_bf16(h, w, (const int*)labels, (const float*)lse,
                       (const float*)g_eff, dh, dw, dchunk, (float*)dh32, n,
                       vocab, hidden, width, (cudaStream_t)stream);
}

// The dynamic shared memory a bf16 backward block launches with.
extern "C" int fused_ce_bwd_bf16_smem() { return (int)bw::kSmem; }
