// The bf16 online-softmax attention forward on warpgroup products
// (hopper_tiles.cuh), shared by the tiled flash forward
// (flash_attention.cu, TPU kernel #7) and the splash forward
// (splash_attention.cu, #9); each source wraps `fwd_body` in a __global__
// kernel of its own, so a profile names them apart. The fp32 routes stay
// on attention_tiles.cuh's `fwd_body` (wgmma has no true-fp32 form).
//
// The contract is the TPU kernels' (and attention_tiles.cuh's): per key
// tile s = q . k^T * scale in fp32, masked causally and by segment ids; a
// running row max m and sum l in fp32 with corr = exp(m_prev - m_new);
// p = exp(s - m_new) unnormalised, rounded to bf16 for P.V; an fp32
// accumulator rescaled by corr; out = acc / l (l == 0 -> 1) and
// lse = m + log l ([b, nh, sq] fp32, +inf for a row with no visible key).
// A tile fully masked for a row leaves that row's state as it was: where
// m_new is still -inf the row subtracts 0 instead, so p = 0 and
// corr = exp(-inf) = 0 on an accumulator that is still 0 (never
// exp(-inf - -inf)).
//
// Design: a persistent grid of min(items, SMs) blocks walks work items of
// (128 query rows, head, batch), the longest causal rows first. A block
// is two consumer warpgroups of 64 rows each and a producer warpgroup
// whose first warp does the producing; with setmaxnreg the producer keeps
// 40 registers a thread and the consumers take 232, which lifts the cap
// of 168 a thread that 384 threads a block would otherwise set. The
// producer keeps 128-key K and V tiles in flight in a ring (3 stages at
// head dim 64, 2 at 128), K and V with barriers of their own, by TMA
// straight from the strided views: a 4-D tensor map over (d, heads, rows,
// batch), the kv head h / (nh / kvh) for GQA, so the hardware zero-fills
// ragged rows and the padded head dim and no load is masked. It loads the
// next item's Q into a second buffer. With segment ids (kSeg) its warp
// also writes each key tile's ids beside it, and every lane arrives on the
// tile's barrier. A consumer warpgroup reads its rows' ids once an item.
// Per key tile a warpgroup computes S = Q K^T as an SS wgmma into
// registers (64 rows x 128 keys, both K-major), in log2 units
// (scale * log2 e); only a tile on the diagonal or at the ragged end is
// masked (every tile with segments). The K tile goes back to the producer
// as soon as its scores are masked. The row max and sum stay in
// registers, a quad of lanes per row; P is packed into the bf16 A
// registers of an RS wgmma for O += P V (V MN-major), O in registers.
// Nothing of S or P touches shared memory. Tile j's S is issued together
// with tile j - 1's P.V, so the warpgroup waits for one product batch, not
// two, and at head dim 64 the two warpgroups take turns to issue them (a
// ping-pong on named barriers), so one's softmax runs under the other's
// products. Key tiles past the diagonal are skipped. The epilogue stores
// O / l as paired bf16 values and lse = (m + log2 l) ln 2 (natural units:
// the backward kernels compute exp(s * scale - lse)), +inf where l == 0.
//
// What bounds it on the H100: the two products over the causal pairs
// (2 * 2 * pairs * d flops at 989 TFLOP/s) against q, k, v, out and lse
// read or written once at 3.35 TB/s; at d 64 the two are close (splash at
// [8, 1024, 32, 64]: 0.040 ms of bytes, 0.035 ms of products; the tiled
// flash at [4, 2048, 32, 64]: 0.069 ms of products). What the design still
// leaves on the table: the softmax's exponentials (64 exp2 a thread a
// tile on the SFU, about as long as the tile's products) overlap the
// other warpgroup's products only; the diagonal tile's masked half is
// computed; the output goes out in 4-byte stores; at head dim 128 there
// is no ping-pong.
#pragma once

#include "attention_tiles.cuh"
#include "hopper_tiles.cuh"

namespace attn_wg {

using attn::Geometry;
using attn::View;
using hop::fence_a;
using hop::issue_rs;
using hop::issue_ss;
using hop::named_arrive;
using hop::named_sync;
using hop::reg_alloc;
using hop::reg_dealloc;

constexpr int kRows = 128;   // query rows of an item, keys of a tile
// two consumer warpgroups and a producer warpgroup (setmaxnreg moves
// registers between warpgroups only)
constexpr int kThreads = hop::kConsumers + 128;

// Shared memory of a block: two Q tiles, the K and V rings, each K stage's
// segment ids (kSeg), the mbarriers. D: the head dim padded to 64 or 128.
template <int D, bool kSeg>
struct FwdSmem {
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kPanel = kRows * hop::kRowBytes;          // 16 KB
  static constexpr int kTile = kPanels * kPanel;     // Q, K or V tile
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + 2 * kTile;
  static constexpr size_t kV = kK + (size_t)kStages * kTile;
  static constexpr size_t kSegK = kV + (size_t)kStages * kTile;
  static constexpr size_t kBars =
      kSegK + (kSeg ? (size_t)kStages * kRows * sizeof(int) : 0);
  // q full / empty [2 each], then k full, k empty, v full, v empty
  static constexpr size_t kBytes = kBars + (4 + 4 * kStages) * 8 + 1024;
};

// One (128 query rows, head, batch) work item of the persistent walk,
// longest causal rows first.
struct FwdItem {
  int q0, h, kh, b, n_kt;
  __device__ FwdItem(int item, int batch, const Geometry& g) {
    const int nq = (g.sq + kRows - 1) / kRows, per_q = g.nh * batch;
    const int qt = nq - 1 - item / per_q, rem = item % per_q;
    q0 = qt * kRows;
    h = rem % g.nh;
    b = rem / g.nh;
    kh = h / (g.nh / g.kvh);
    const int nk = (g.sk + kRows - 1) / kRows;
    n_kt = g.causal ? min(nk, qt + 1) : nk;
  }
};

// Scale the raw products of a tile of N keys to log2 units; keys past
// sk, past the diagonal or of another segment -inf. Only a tile that
// needs it is masked.
template <bool kSeg, int N = kRows>
__device__ __forceinline__ void mask_scores(float (&s)[N / 2], int t, int k0,
                                            int row0, int rows_lo,
                                            const int* ids,
                                            const int (&seg_r)[2],
                                            float sl2, const Geometry& g) {
  if (kSeg || k0 + N > g.sk || (g.causal && k0 + N - 1 > rows_lo)) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int c = hop::acc_col(t, i), j = k0 + c, r = (i >> 1) & 1;
      bool vis = j < g.sk && (!g.causal || j <= row0 + 8 * r);
      if constexpr (kSeg) vis = vis && ids[c] == seg_r[r];
      s[i] = vis ? s[i] * sl2 : -INFINITY;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] *= sl2;
  }
}

// The online-softmax step of one tile: s (scaled) becomes p = 2^(s - m),
// m and the thread's partial row sums l are updated, corr is the factor
// for the accumulator.
__device__ __forceinline__ void softmax_step(float (&s)[64], float (&m)[2],
                                             float (&l)[2],
                                             float (&corr)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], hop::quad_max(mx[r]));
    mu[r] = mn == -INFINITY ? 0.f : mn;   // no visible key yet
    corr[r] = exp2f(m[r] - mu[r]);
    m[r] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2f(s[i] - mu[r]);
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

template <int D, bool kSeg>
__device__ __forceinline__ void fwd_body(const CUtensorMap& tq,
                                         const CUtensorMap& tk,
                                         const CUtensorMap& tv,
                                         __nv_bfloat16* __restrict__ out,
                                         float* __restrict__ lse,
                                         const int* __restrict__ seg,
                                         const Geometry& g, int batch) {
  using L = FwdSmem<D, kSeg>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hop::align1024(smem_raw);
  uint64_t* q_full = (uint64_t*)(sm + L::kBars);   // [2]
  uint64_t* q_empty = q_full + 2;                   // [2]
  uint64_t* k_full = q_empty + 2;
  uint64_t* k_empty = k_full + L::kStages;
  uint64_t* v_full = k_empty + L::kStages;
  uint64_t* v_empty = v_full + L::kStages;
  int* seg_k = (int*)(sm + L::kSegK);               // [stages][128], kSeg
  const int n_items = (g.sq + kRows - 1) / kRows * g.nh * batch;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hop::bar_init(&q_full[i], 1);
      hop::bar_init(&q_empty[i], hop::kConsumers);
    }
    for (int s = 0; s < L::kStages; ++s) {
      hop::bar_init(&k_full[s], kSeg ? 32 : 1);
      hop::bar_init(&k_empty[s], hop::kConsumers);
      hop::bar_init(&v_full[s], 1);
      hop::bar_init(&v_empty[s], hop::kConsumers);
    }
    hop::bar_fence_init();
  }
  __syncthreads();

  if (tid >= hop::kConsumers) {
    // producer: for each item, Q into one of two buffers, then K and V
    // tiles; it runs into the next item while the consumers finish this
    // one. Lane 0 of its first warp issues the copies; with segment ids
    // every lane of that warp writes four of a K tile's ids and arrives
    // on its barrier. The warpgroup gives its registers to the consumers.
    reg_dealloc<40>();
    const int lane = tid - hop::kConsumers;
    if (lane >= 32 || (!kSeg && lane)) return;
    hop::Ring ring(L::kStages, 1);
    for (int it = 0, item = blockIdx.x; item < n_items;
         ++it, item += gridDim.x) {
      const FwdItem w(item, batch, g);
      if (lane == 0) {
        const int qb = it & 1;
        hop::bar_wait(&q_empty[qb], ((it >> 1) & 1) ^ 1);
        hop::bar_arrive_tx(&q_full[qb], L::kTile);
        for (int p = 0; p < L::kPanels; ++p)
          hop::load_4d(sm + L::kQ + qb * L::kTile + p * L::kPanel, &tq,
                       &q_full[qb], 64 * p, w.h, w.q0, w.b);
      }
      for (int kt = 0; kt < w.n_kt; ++kt, ring.advance()) {
        const int k0 = kt * kRows, st = ring.stage;
        const size_t off = (size_t)st * L::kTile;
        hop::bar_wait(&k_empty[st], ring.phase);
        if constexpr (kSeg) {
          int* ids = seg_k + st * kRows;
          for (int j = lane; j < kRows; j += 32)
            ids[j] = k0 + j < g.sk ? seg[(size_t)w.b * g.sq + k0 + j] : -2;
          if (lane) {
            hop::bar_arrive(&k_full[st]);
            continue;
          }
        }
        hop::bar_arrive_tx(&k_full[st], L::kTile);
        for (int p = 0; p < L::kPanels; ++p)
          hop::load_4d(sm + L::kK + off + p * L::kPanel, &tk, &k_full[st],
                       64 * p, w.kh, k0, w.b);
        hop::bar_wait(&v_empty[st], ring.phase);
        hop::bar_arrive_tx(&v_full[st], L::kTile);
        for (int p = 0; p < L::kPanels; ++p)
          hop::load_4d(sm + L::kV + off + p * L::kPanel, &tv, &v_full[st],
                       64 * p, w.kh, k0, w.b);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
  // of each item; thread t holds rows row0 and row0 + 8 of them
  const int wg = tid >> 7, t = tid & 127;
  const float sl2 = g.scale * 1.4426950408889634f;   // scale * log2(e)
  const uint32_t k_base = hop::smem_addr(sm + L::kK);
  const uint32_t v_base = hop::smem_addr(sm + L::kV);
  reg_alloc<232>();
  // ping-pong at head dim 64: a warpgroup issues its products only in its
  // turn, so one's softmax runs under the other's products (at 128 the
  // turns' extra live registers spill)
  constexpr bool kPingPong = D == 64;
  hop::Ring kr(L::kStages, 0), vr(L::kStages, 0);   // S's tiles, P.V's
  if (kPingPong && wg == 1) named_arrive(1);   // warpgroup 0 goes first
  for (int it = 0, item = blockIdx.x; item < n_items;
       ++it, item += gridDim.x) {
    const FwdItem w(item, batch, g);
    const int qb = it & 1;
    const int rows_lo = w.q0 + 64 * wg;
    const int row0 = rows_lo + hop::acc_row(t, 0);
    const uint32_t q_addr = hop::smem_addr(sm + L::kQ + qb * L::kTile) +
                            64 * wg * hop::kRowBytes;
    int seg_r[2] = {0, 0};
    if constexpr (kSeg) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + 8 * r;
        seg_r[r] = i < g.sq ? seg[(size_t)w.b * g.sq + i] : -1;
      }
    }
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    float s[64];
    uint32_t a[kRows / 16][4];
    hop::bar_wait(&q_full[qb], (it >> 1) & 1);
    // tile 0: S, softmax
    hop::bar_wait(&k_full[kr.stage], kr.phase);
    if (kPingPong) named_sync(1 + wg);
    issue_ss<kRows, D>(s, q_addr, L::kPanel, k_base + kr.stage * L::kTile,
                       L::kPanel);
    if (kPingPong) named_arrive(2 - wg);
    hop::wait<0>();
    hop::fence_regs(s);
    mask_scores<kSeg>(s, t, 0, row0, rows_lo, seg_k + kr.stage * kRows,
                      seg_r, sl2, g);
    hop::bar_arrive(&k_empty[kr.stage]);
    kr.advance();
    if (w.n_kt == 1) hop::bar_arrive(&q_empty[qb]);
    softmax_step(s, m, l, corr);
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) hop::pack_a(s, kk, a[kk]);
    // tile kt's S with tile kt - 1's P.V
    for (int kt = 1; kt < w.n_kt; ++kt) {
      hop::bar_wait(&k_full[kr.stage], kr.phase);
      hop::bar_wait(&v_full[vr.stage], vr.phase);
      if (kPingPong) named_sync(1 + wg);
      issue_ss<kRows, D>(s, q_addr, L::kPanel,
                         k_base + kr.stage * L::kTile, L::kPanel);
      issue_rs<D, kRows>(o, a, v_base + vr.stage * L::kTile, L::kPanel);
      if (kPingPong) named_arrive(2 - wg);
      hop::wait<1>();
      hop::fence_regs(s);
      mask_scores<kSeg>(s, t, kt * kRows, row0, rows_lo,
                        seg_k + kr.stage * kRows, seg_r, sl2, g);
      hop::bar_arrive(&k_empty[kr.stage]);
      kr.advance();
      if (kt + 1 == w.n_kt) hop::bar_arrive(&q_empty[qb]);
      softmax_step(s, m, l, corr);
      hop::wait<0>();
      hop::fence_regs(o);
      fence_a(a);
      hop::bar_arrive(&v_empty[vr.stage]);
      vr.advance();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) hop::pack_a(s, kk, a[kk]);
    }
    // the last P.V
    hop::bar_wait(&v_full[vr.stage], vr.phase);
    issue_rs<D, kRows>(o, a, v_base + vr.stage * L::kTile, L::kPanel);
    hop::wait<0>();
    hop::fence_regs(o);
    hop::bar_arrive(&v_empty[vr.stage]);
    vr.advance();

    // out = O / l as paired bf16 stores; lse in natural units
    const float lt[2] = {hop::quad_sum(l[0]), hop::quad_sum(l[1])};
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i >> 1) & 1, row = row0 + 8 * r, c = hop::acc_col(t, i);
      const float den = lt[r] == 0.f ? 1.f : lt[r];
      if (row < g.sq && c < g.d)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)w.b * g.sq + row) * g.nh + w.h) * g.d + c) =
            __floats2bfloat162_rn(o[i] / den, o[i + 1] / den);
    }
    if ((t & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < g.sq)
          lse[((size_t)w.b * g.nh + w.h) * g.sq + row] =
              lt[r] > 0.f ? (m[r] + log2f(lt[r])) * 0.6931471805599453f
                          : INFINITY;
      }
    }
  }
  if (kPingPong && wg == 0) named_sync(1);   // warpgroup 1's last turn
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// A persistent grid: one block an SM, at most one a work item.
inline cudaError_t persistent_grid(long long items, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)))
    return err;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  *grid = (int)(items < sms ? items : sms);
  return cudaSuccess;
}

// A bf16 tensor map of a [b, rows, heads, d] view (element strides v):
// dims (d, heads, rows, batch), boxes of 64 columns x box_rows rows.
inline cudaError_t view_map(CUtensorMap* map, const void* p, View v,
                            int heads, int rows, int b, int d,
                            int box_rows) {
  const long long dims[4] = {d, heads, rows, b};
  const long long strides[3] = {v.h, v.s, v.b};
  const int box[4] = {64, 1, box_rows, 1};
  return hop::make_map(map, p, 4, dims, strides, box);
}

// The q, k, v views' maps, boxes of 128 rows.
inline cudaError_t qkv_maps(CUtensorMap (&maps)[3], const void* q,
                            const void* k, const void* v, View qv, View kv,
                            View vv, int b, const Geometry& g) {
  cudaError_t err;
  if ((err = view_map(&maps[0], q, qv, g.nh, g.sq, b, g.d, kRows)) ||
      (err = view_map(&maps[1], k, kv, g.kvh, g.sk, b, g.d, kRows)) ||
      (err = view_map(&maps[2], v, vv, g.kvh, g.sk, b, g.d, kRows)))
    return err;
  return cudaSuccess;
}

// The bf16 forward of one source's kernel instantiation for <D, kSeg>.
template <int D, bool kSeg, typename Kernel>
cudaError_t launch_fwd(Kernel kernel, const void* q, const void* k,
                       const void* v, void* out, float* lse, const int* seg,
                       View qv, View kv, View vv, int b, const Geometry& g,
                       cudaStream_t stream) {
  CUtensorMap maps[3];
  cudaError_t err = qkv_maps(maps, q, k, v, qv, kv, vv, b, g);
  if (err != cudaSuccess) return err;
  const size_t smem = FwdSmem<D, kSeg>::kBytes;
  if ((err = hop::prepare(kernel, smem)) != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid((long long)((g.sq + kRows - 1) / kRows) * g.nh * b,
                        &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)out, lse, seg, g, b);
  return cudaGetLastError();
}

}  // namespace attn_wg
