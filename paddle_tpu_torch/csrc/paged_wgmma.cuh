// The bf16 chunked-prefill attention over paged K/V on warpgroup products
// (hopper_tiles.cuh): TPU kernels #3 (fp pools) and #4 (int8 / int4
// pools), `_chunk_kernel` of paddle_tpu/ops/pallas/paged_attention.py,
// for bf16 queries over bf16, int8 or int4 pools (paged_attention.cu
// wraps `chunk_body` as paged_chunk_wgmma_kernel<D, mode>). The fp32
// route and the decode kernels (#1/#2) stay on paged_attention.cu's
// `attend_pages`.
//
// The contract is the TPU kernel's and the plain version's
// (paged_attention_chunk_ref): query i of slot b sits at position
// start[b] + i and sees keys at positions <= that, up to the page table's
// end; s = q . k in fp32 (k dequantized: int * its row's scale), an
// fp32 online softmax, P kept in fp32 for P.V (the TPU kernel's
// `e.astype(jnp.float32)`), out = acc / l in q's dtype. Here q and a
// bf16 pool's keys are bf16 and a quantized pool's integers are exact in
// bf16 (|v| <= 128), so S is exact products with fp32 sums; a
// quantized key's scale multiplies its column of S. P (times v's scale)
// is split into three bf16 parts, each the rest the ones before it left,
// and all three go through the P.V product into one fp32 accumulator:
// their sum is P to fp32's 24 bits, where one bf16 P would keep 8.
//
// Design: one block per (slot, kv head, 64 query rows; row r = g * c + i
// over the group's heads g, as the TPU kernel orders its q block), three
// warpgroups (setmaxnreg: 72 registers a thread for the producer, 216 for
// the consumers). The consumers load the block's Q rows (a [64 x d] tile,
// zero past the rows and past d) into swizzled panels. The producer
// warpgroup walks the slot's page table 64 keys at a time, only to the
// last key any of the block's rows sees (pages above it are never read),
// into a ring of 4 stages: each thread looks up its keys' pages and
// copies their rows with cp.async (16, 8 or 4 bytes, as the rows and the
// pools' alignment allow), bf16 rows straight into the swizzled K and V
// panels, int8 and packed int4 rows into a raw staging tile that the
// same thread then widens to bf16 integers in the panels (int4: high
// nibble the even lane, minus 8), with each key's fp32 k and v scales
// beside the tile. Keys past the walk's end are zero-filled; the padded
// head dims stay zero from the block's start. The producer keeps two
// tiles in flight (it issues tile j, then finishes tile j - 1), fences
// its writes for the async proxy and arrives on the tile's barrier.
// The two consumer warpgroups split the keys: warpgroup w takes tiles
// j = w, w + 2, ... (stages w and w + 2 of the ring), each with its own
// row max, sum and [64 x D] accumulator in registers: S = Q K^T as an SS
// wgmma (both K-major), the mask and the k scales, the online softmax in
// natural units (expf, as the plain version and the fp32 route: the
// output is held to theirs at one bf16 rounding), then O = O corr + P V
// from P's three parts as RS wgmmas (V MN-major). At the end warpgroup 1
// leaves its state in shared memory and warpgroup 0 merges the two in
// that fixed order and stores out = O / l (l == 0 -> 1) as paired bf16
// values: no float atomics.
//
// What bounds it on the H100: bytes. The visible K and V rows are read
// once per block (one block per slot and kv head whenever (nh / kvh) * c
// <= 64), 2 * keys * row bytes a head, plus q and out once; the products
// (2 * 2 * rows * keys * d, three products with P's two parts) are far
// below the tensor cores' rate. What the design leaves on the table: a
// slot's keys are walked by one block (two warpgroups), so at few slots
// and long contexts most SMs idle (split-K over blocks with a combine
// pass would fix it); a consumer waits for each tile's S before its
// softmax and for its P.V before the next S; P.V is three products
// where the bytes would allow one; the int pools' widening runs on the
// producer's CUDA cores.
#pragma once

#include "hopper_tiles.cuh"

namespace paged_wg {

constexpr int kRows = 64;    // query rows of a block
constexpr int kKeys = 64;    // keys of a tile
constexpr int kStages = 4;   // even: a stage's tiles go to one warpgroup
constexpr int kThreads = hop::kConsumers + 128;
constexpr int kPanel = kRows * hop::kRowBytes;   // 8 KB: 64 rows x 64 cols

// Pool modes.
constexpr int kBf16 = 0, kInt8 = 1, kInt4 = 2;

struct ChunkArgs {
  const __nv_bfloat16* q;       // [b, c, nh, d]
  __nv_bfloat16* out;           // [b, c, nh, d]
  const unsigned char* k;       // [kvh, num_pages, ps, row bytes]
  const unsigned char* v;
  const float* ks;              // [kvh, num_pages, ps] (quantized pools)
  const float* vs;
  const int* pt;                // [b, pp]
  const int* start;             // [b]
  int c, nh, kvh, d, num_pages, ps, pp;
  float scale;
  int cp_bytes;                 // a cp.async's size: 16, 8 or 4
};

// Shared memory: the Q tile, the K and V rings, and for quantized pools
// the raw rows and the scales of each stage, then the barriers. D: the
// head dim padded to 64 or 128.
template <int D, int kMode>
struct ChunkSmem {
  static constexpr int kPanels = D / 64;
  static constexpr int kTile = kPanels * kPanel;
  // a stage's raw K (then V) rows: int8 D bytes a row, int4 D / 2
  static constexpr int kRawRows =
      kMode == kInt8 ? kKeys * D : kMode == kInt4 ? kKeys * D / 2 : 0;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + kTile;
  static constexpr size_t kV = kK + (size_t)kStages * kTile;
  static constexpr size_t kRaw = kV + (size_t)kStages * kTile;
  static constexpr size_t kScales = kRaw + (size_t)kStages * 2 * kRawRows;
  static constexpr size_t kBars =
      kScales + (kMode ? (size_t)kStages * 2 * kKeys * 4 : 0);
  // full [stages], empty [stages]
  static constexpr size_t kBytes = kBars + 2 * kStages * 8 + 1024;
  // warpgroup 1's state at the end ([64][D] fp32, then m and l [64]
  // each) over the K ring, which every product has read by then
  static_assert(kStages * kTile >= (kRows * D + 2 * kRows) * 4, "merge");
};

// Byte offset of byte `col` of row r in a row of swizzled panels.
__device__ __forceinline__ uint32_t panel_byte(int r, int col) {
  return (col >> 7) * kPanel + r * hop::kRowBytes +
         ((((col >> 4) & 7) ^ (r & 7)) << 4) + (col & 15);
}

// acc[64 x N] (+)= (A_0 + A_1 + A_2) B in one product batch, A's three
// bf16 parts from registers (B MN-major); kAdd: onto acc, else from 0.
template <int N, int K, bool kAdd>
__device__ __forceinline__ void issue_rs3(float (&acc)[N / 2],
                                          const uint32_t (&a)[3][K / 16][4],
                                          uint32_t b, uint32_t b_panel) {
  hop::fence_regs(acc);
  hop::fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db =
        hop::desc(b + kk * 16 * hop::kRowBytes, b_panel, 1024);
#pragma unroll
    for (int part = 0; part < 3; ++part)
      hop::mma_rs<N, 1>(acc, a[part][kk], db, kAdd || kk || part);
  }
  hop::commit();
}

// Widen `bytes` raw bytes of a quantized row (its byte offset `col` in
// the row) to bf16 integers at their head dims in the row's panels.
template <int kMode>
__device__ __forceinline__ void widen(const unsigned char* raw, int bytes,
                                      unsigned char* panels, int r,
                                      int col) {
  for (int i = 0; i < bytes; i += 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(raw + i);
    if constexpr (kMode == kInt8) {
      const int e = col + i;   // head dim of the first byte
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lo = (int8_t)(w >> (16 * h));
        const int hi = (int8_t)(w >> (16 * h + 8));
        *reinterpret_cast<uint32_t*>(panels +
                                     panel_byte(r, 2 * (e + 2 * h))) =
            hop::pack_bf16((float)lo, (float)hi);
      }
    } else {
      const int e = 2 * (col + i);
#pragma unroll
      for (int by = 0; by < 4; ++by) {
        const uint32_t x = (w >> (8 * by)) & 0xffu;
        *reinterpret_cast<uint32_t*>(panels +
                                     panel_byte(r, 2 * (e + 2 * by))) =
            hop::pack_bf16((float)((int)(x >> 4) - 8),
                           (float)((int)(x & 0xfu) - 8));
      }
    }
  }
}

template <int D, int kMode>
__device__ __forceinline__ void chunk_body(const ChunkArgs& a) {
  using L = ChunkSmem<D, kMode>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hop::align1024(smem_raw);
  uint64_t* full = (uint64_t*)(sm + L::kBars);
  uint64_t* empty = full + kStages;
  const int b = blockIdx.x, kh = blockIdx.y, r0 = blockIdx.z * kRows;
  const int grp = a.nh / a.kvh, rows = grp * a.c;
  const int R = min(kRows, rows - r0);
  const int st = a.start[b];
  // the largest chunk index among the block's rows sees the most keys
  const int i_max =
      (r0 / a.c != (r0 + R - 1) / a.c) ? a.c - 1 : (r0 + R - 1) % a.c;
  const int n_keys = max(0, min(a.pp * a.ps, st + i_max + 1));
  const int nt = (n_keys + kKeys - 1) / kKeys;
  const int tid = threadIdx.x;

  // the K and V rings start as zeros (the padded head dims stay so)
  for (int i = tid; i < 2 * kStages * L::kTile / 16; i += kThreads)
    reinterpret_cast<uint4*>(sm + L::kK)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::bar_init(&full[s], 128);                // the producer's threads
      hop::bar_init(&empty[s], 128);               // one consumer warpgroup
    }
    hop::bar_fence_init();
  }
  if (tid < hop::kConsumers) {
    // Q row r: head kh * grp + r / c, chunk index r % c; zeros past the
    // rows and past d, 16 bytes a thread
    for (int idx = tid; idx < kRows * D / 8; idx += hop::kConsumers) {
      const int r = idx / (D / 8), col = 8 * (idx % (D / 8));
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < R && col < a.d) {
        const int row = r0 + r, g = row / a.c, i = row - g * a.c;
        x = *reinterpret_cast<const uint4*>(
            a.q + (((size_t)b * a.c + i) * a.nh + kh * grp + g) * a.d + col);
      }
      *reinterpret_cast<uint4*>(sm + L::kQ + panel_byte(r, 2 * col)) = x;
    }
  }
  hop::fence_async_smem();
  __syncthreads();

  if (tid >= hop::kConsumers) {
    // producer: tile j's copies, then tile j - 1 finished (its copies
    // waited for, quantized rows widened, fenced, arrived)
    hop::reg_dealloc<72>();
    const int p = tid - hop::kConsumers;
    constexpr int kVals = kMode == kInt4 ? 2 : 1;   // values a pool byte
    const int row_bytes = kMode == kBf16 ? 2 * a.d : a.d / kVals;
    const int cb = a.cp_bytes, per_row = row_bytes / cb;
    const size_t head = (size_t)kh * a.num_pages;
    const int* pt_row = a.pt + (size_t)b * a.pp;
    auto issue = [&](int kt) {
      const int s = kt % kStages;
      for (int idx = p; idx < kKeys * per_row; idx += 128) {
        const int j = idx / per_row, col = (idx - j * per_row) * cb;
        const int pos = kt * kKeys + j;
        const bool in = pos < n_keys;
        const size_t at =
            in ? ((head + pt_row[pos / a.ps]) * a.ps + pos % a.ps) *
                         row_bytes + col
               : 0;
        if constexpr (kMode == kBf16) {
          const uint32_t off = s * L::kTile + panel_byte(j, col);
          hop::cp_async(sm + L::kK + off, a.k + at, cb, in);
          hop::cp_async(sm + L::kV + off, a.v + at, cb, in);
        } else {
          unsigned char* raw = sm + L::kRaw + (size_t)s * 2 * L::kRawRows +
                               j * row_bytes + col;
          hop::cp_async(raw, a.k + at, cb, in);
          hop::cp_async(raw + L::kRawRows, a.v + at, cb, in);
        }
      }
      if constexpr (kMode != kBf16) {
        // thread p < 64: key p's k scale; 64..127: key p - 64's v scale
        const int j = p & (kKeys - 1), pos = kt * kKeys + j;
        const bool in = pos < n_keys;
        const size_t r =
            in ? (head + pt_row[pos / a.ps]) * a.ps + pos % a.ps : 0;
        hop::cp_async(sm + L::kScales + (size_t)s * 2 * kKeys * 4 + p * 4,
                      (p < kKeys ? a.ks : a.vs) + r, 4, in);
      }
      hop::cp_async_commit();
    };
    auto finish = [&](int kt) {
      const int s = kt % kStages;
      if constexpr (kMode != kBf16) {
        for (int idx = p; idx < kKeys * per_row; idx += 128) {
          const int j = idx / per_row, col = (idx - j * per_row) * cb;
          const unsigned char* raw = sm + L::kRaw +
                                     (size_t)s * 2 * L::kRawRows +
                                     j * row_bytes + col;
          widen<kMode>(raw, cb, sm + L::kK + s * L::kTile, j, col);
          widen<kMode>(raw + L::kRawRows, cb, sm + L::kV + s * L::kTile, j,
                       col);
        }
      }
      hop::fence_async_smem();
      hop::bar_arrive(&full[s]);
    };
    for (int kt = 0; kt < nt; ++kt) {
      hop::bar_wait(&empty[kt % kStages], ((kt / kStages) & 1) ^ 1);
      issue(kt);
      if (kt > 0) {
        hop::cp_async_wait<1>();
        finish(kt - 1);
      }
    }
    if (nt > 0) {
      hop::cp_async_wait<0>();
      finish(nt - 1);
    }
    return;
  }

  // consumers: warpgroup wg takes key tiles wg, wg + 2, ...; thread t
  // holds rows row_a and row_a + 8 of the block
  const int wg = tid >> 7, t = tid & 127;
  hop::reg_alloc<216>();   // 128 x 72 + 256 x 216 = the block's 384 x 168
  const int row_a = hop::acc_row(t, 0);
  int lim[2];   // the last key position each of the thread's rows sees
#pragma unroll
  for (int r = 0; r < 2; ++r) lim[r] = st + (r0 + row_a + 8 * r) % a.c;
  const uint32_t q_addr = hop::smem_addr(sm + L::kQ);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = wg; kt < nt; kt += 2) {
    const int s = kt % kStages;
    hop::bar_wait(&full[s], (kt / kStages) & 1);
    float x[kKeys / 2];
    hop::issue_ss<kKeys, D>(x, q_addr, kPanel,
                            hop::smem_addr(sm + L::kK + s * L::kTile),
                            kPanel);
    hop::wait<0>();
    hop::fence_regs(x);
    const float* ksc = (const float*)(sm + L::kScales) + s * 2 * kKeys;
    const float* vsc = ksc + kKeys;
    // times the key's scale and the softmax scale, masked
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int col = hop::acc_col(t, i), pos = kt * kKeys + col;
      const int r = (i >> 1) & 1;
      float y = x[i];
      if constexpr (kMode != kBf16) y *= ksc[col];
      y *= a.scale;
      x[i] = pos <= lim[r] && pos < n_keys ? y : -INFINITY;
      mx[r] = fmaxf(mx[r], x[i]);
    }
    float mu[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], hop::quad_max(mx[r]));
      mu[r] = mn == -INFINITY ? 0.f : mn;   // no visible key yet
      corr[r] = expf(m[r] - mu[r]);
      m[r] = mn;
    }
    // p (times v's scale) as three bf16 parts, each taking what the
    // ones before left: their sum is p to fp32's precision
    float sum[2] = {0.f, 0.f};
    uint32_t pa[3][kKeys / 16][4];
#pragma unroll
    for (int i = 0; i < kKeys / 2; i += 2) {
      const int r = (i >> 1) & 1;
      float e[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        e[u] = expf(x[i + u] - mu[r]);
        sum[r] += e[u];
        if constexpr (kMode != kBf16) e[u] *= vsc[hop::acc_col(t, i + u)];
      }
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(e[0], e[1]);
        pa[part][i / 8][(i % 8) / 2] =
            *reinterpret_cast<const uint32_t*>(&h);
        e[0] -= __low2float(h);
        e[1] -= __high2float(h);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
    // At head dim 64 the tile's P.V comes apart, then O = O corr + P.V
    // in fp32 registers: the products' own sums (not rounded to nearest
    // between steps) run over one tile only, which brings the outputs'
    // bf16 roundings closer to the fp32 route's. At 128 the second
    // [64 x 128] accumulator would spill, so the products add onto O.
    const uint32_t v_addr = hop::smem_addr(sm + L::kV + s * L::kTile);
    if constexpr (D == 64) {
      float pv[D / 2];
      issue_rs3<D, kKeys, false>(pv, pa, v_addr, kPanel);
      hop::wait<0>();
      hop::fence_regs(pv);
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        o[i] = fmaf(o[i], corr[(i >> 1) & 1], pv[i]);
    } else {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      issue_rs3<D, kKeys, true>(o, pa, v_addr, kPanel);
      hop::wait<0>();
      hop::fence_regs(o);
    }
#pragma unroll
    for (int part = 0; part < 3; ++part) hop::fence_a(pa[part]);
    hop::bar_arrive(&empty[s]);
  }

  // merge: warpgroup 1's state through shared memory, then warpgroup 0
  // combines (its own first) and stores
  float* xo = (float*)(sm + L::kK);        // [64][D]
  float* xm = xo + kRows * D;              // [64]
  float* xl = xm + kRows;                  // [64]
  const float lt[2] = {hop::quad_sum(l[0]), hop::quad_sum(l[1])};
  hop::named_sync(1);                      // every product has read the ring
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      xo[hop::acc_row(t, i) * D + hop::acc_col(t, i)] = o[i];
    if ((t & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xm[row_a + 8 * r] = m[r];
        xl[row_a + 8 * r] = lt[r];
      }
    }
  }
  hop::named_sync(1);
  if (wg == 1) return;
  float w0[2], w1[2], den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = xm[row_a + 8 * r];
    const float mn = fmaxf(m[r], m1);
    w0[r] = m[r] == -INFINITY ? 0.f : expf(m[r] - mn);
    w1[r] = m1 == -INFINITY ? 0.f : expf(m1 - mn);
    const float l01 = lt[r] * w0[r] + xl[row_a + 8 * r] * w1[r];
    den[r] = l01 == 0.f ? 1.f : l01;
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i >> 1) & 1, rr = hop::acc_row(t, i);
    const int col = hop::acc_col(t, i), row = r0 + rr;
    if (rr < R && col < a.d) {
      const float* y = xo + rr * D + col;
      const int g = row / a.c, ci = row - g * a.c;
      *reinterpret_cast<__nv_bfloat162*>(
          a.out + (((size_t)b * a.c + ci) * a.nh + kh * grp + g) * a.d +
          col) =
          __floats2bfloat162_rn((o[i] * w0[r] + y[0] * w1[r]) / den[r],
                                (o[i + 1] * w0[r] + y[1] * w1[r]) / den[r]);
    }
  }
}

}  // namespace paged_wg
