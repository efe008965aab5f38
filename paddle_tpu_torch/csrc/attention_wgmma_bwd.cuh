// The bf16 attention backward on warpgroup products (hopper_tiles.cuh):
// the single-block flash backward (flash_attention.cu, TPU kernel #6),
// the tiled flash backward from an outside lse (#8) and the splash
// backward (splash_attention.cu, #10) with GQA and segment ids. The fp32
// routes stay on attention_tiles.cuh's bodies (wgmma has no true-fp32
// form).
//
// The contract is the TPU kernels' and the plain versions'
// (ops/kernels/flash_attention.py, splash_attention.py): s = q . k^T in
// fp32, a key of another segment or past the diagonal masked (key j is
// visible to row i when j <= i: causal takes sq == sk); p = exp(s * scale
// - lse) from the forward's (or a ring's global) lse, or for #6 the exact
// softmax p = exp(s * scale - m) / l, normalised before any cast; P rounded
// to bf16 for dV += P^T dO; dP = dO V^T in fp32; dS = p (dP - delta) scale
// rounded to bf16 for dK += dS^T Q and dQ += dS K; fp32 sums, each
// gradient cast once. A row with no visible key has lse +inf, so p =
// exp2(-inf) = 0 and its gradients are 0, never NaN. delta is
// rowsum(dO * O) for #8 and #10 (flash_delta_kernel / splash_delta_kernel,
// from the given out) and, for #6, sum_j p_j dP_j, which the dQ kernel
// computes itself: its first walk over the key tiles keeps the row max m,
// the row sum l and that sum online in fp32 and writes m, l and delta to
// a [3, b, nh, sq] fp32 scratch that the dK/dV kernel reads.
//
// Design. Both kernels are persistent (one block an SM) with two consumer
// warpgroups and a producer warpgroup that gives its registers away
// (setmaxnreg: 40 a thread for the dQ producer, 232 for its consumers;
// 56 and 224 in dK/dV, whose producer walks the head group) and feeds a
// ring of tiles by TMA straight from the strided q/k/v views and the
// contiguous dO (4-D tensor maps; ragged rows and padded head dims read as
// zeros, so no load is masked). The products are wgmma with every score
// tile in registers: nothing of S, P, dP or dS touches shared memory.
//   dK/dV (`dkdv_body`), key-tile stationary: an item is (128 keys, kv
//   head, batch), one warpgroup per 64 keys, the longest causal query
//   range first. The item's K and V tiles sit in one of two buffers (the
//   next item's load under this one); for each query head of the kv
//   head's group in a fixed order (GQA), the producer streams 64-row Q
//   and dO tiles of the item's query range, from the diagonal to the end,
//   with the rows' statistics written beside them by its 32 lanes (lse or
//   m in log2 units, delta, 1 / l, and with segment ids the rows' ids;
//   rows past sq get lse +inf, so p = 0 where the copy zero-filled Q).
//   Each thread reads its two keys' ids once an item. Per query tile:
//   S^T = K Q^T (SS, both K-major) and dP^T = V dO^T (SS) issued
//   together; P^T and dS^T = P^T (dP^T - delta) scale in fp32 registers,
//   packed to bf16 A registers; dV += P^T dO and dK += dS^T Q (RS, dO and
//   Q MN-major) issued together. Four products a tile in two batches; dK
//   and dV stay in fp32 registers until one cast and store. Only a tile
//   across the diagonal is masked (every tile with segment ids), and a
//   warpgroup skips a tile wholly above its keys. Keys past sk need no
//   mask: their rows of dK/dV are never stored.
//   dQ (`dq_body`), query-tile stationary: an item is (128 rows, head,
//   batch) as the forward's, one warpgroup per 64 rows; Q and dO in one of
//   two buffers, K and V tiles of 128 keys (64 at head dim 128) of kv
//   head h / (nh / kvh) in a ring, with segment ids each K tile's ids
//   beside it (written by the producer's 32 lanes, as the forward's
//   producer does). Per key tile: S = Q K^T and dP = dO V^T (SS), dS in
//   registers, dQ += dS K (RS, K MN-major): three products. #6's
//   statistics walk adds two (S and dP) a tile, so #6 does nine products
//   where its bound counts five, #8 and #10 seven.
// Every sum is owned by one warpgroup and runs in a fixed order, with no
// float atomics, so a second backward is bit-identical; that is why dQ is
// a kernel of its own rather than accumulated across blocks by atomics.
//
// What bounds them on the H100: the products (2 * 2 * pairs * d flops
// each at 989 TFLOP/s; five for the backward) against q, k, v, dO, the
// gradients and the statistics moved once at 3.35 TB/s: at d 64 the
// products. What the design leaves on the table: each warpgroup runs its
// products and its exponentials in turn (only the other warpgroup's work
// overlaps them; no ping-pong, no S of the next tile issued early), #6's
// statistics walk repeats S and dP, #8's and #10's delta is a kernel of
// its own, the diagonal tiles' masked halves are computed, the gradients
// go out in 4-byte stores, and at head dim 128 the dK/dV consumers spill
// (#6's and splash's with segment ids; off the training path, which runs
// head dim 64).
#pragma once

#include "attention_wgmma.cuh"

namespace attn_wg {

using attn::Stats;

constexpr int kBq = 64;   // query rows of a dK/dV step
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 1 / x for a row sum x >= 1: the approximate reciprocal and one Newton
// step (a division would call a slow path that spills in a producer's
// 40 or 56 registers). Both kernels use it, so they agree on p.
__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.f), r);
}

template <int R>
__device__ __forceinline__ void zero(float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = 0.f;
}

// Paired bf16 stores of a warpgroup's fp32 [64 x D] accumulator to rows
// [r0, r0 + 64) of a contiguous [b, rows, heads, d] gradient; rows past
// `rows` and columns past d are dropped.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           __nv_bfloat16* __restrict__ out,
                                           int t, int r0, int rows, int b,
                                           int h, int heads, int d) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = r0 + hop::acc_row(t, i), c = hop::acc_col(t, i);
    if (r < rows && c < d)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((size_t)b * rows + r) * heads + h) * d + c) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

// Shared memory: two K and V buffers of 128 keys, the ring of 64-row Q
// and dO tiles with their rows' statistics ([3][64] fp32: lse or m in
// log2 units, delta, 1 / l; with segment ids a fourth row, the rows' ids
// as int), the mbarriers. D: the head dim padded to 64 or 128.
template <int D, bool kSeg = false>
struct DkdvSmem {
  static constexpr int kPanels = D / 64;
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kStatRows = kSeg ? 4 : 3;
  static constexpr int kKvPanel = kRows * hop::kRowBytes;   // 16 KB
  static constexpr int kKvTile = kPanels * kKvPanel;
  static constexpr int kQPanel = kBq * hop::kRowBytes;      // 8 KB
  static constexpr int kQTile = kPanels * kQPanel;
  static constexpr size_t kK = 0;
  static constexpr size_t kV = kK + 2 * (size_t)kKvTile;
  static constexpr size_t kQ = kV + 2 * (size_t)kKvTile;
  static constexpr size_t kDo = kQ + (size_t)kStages * kQTile;
  static constexpr size_t kStats = kDo + (size_t)kStages * kQTile;
  static constexpr size_t kBars =
      kStats + (size_t)kStages * kStatRows * kBq * 4;
  // kv full / empty [2 each], then q full, q empty [stages each]
  static constexpr size_t kBytes = kBars + (4 + 2 * kStages) * 8 + 1024;
};

// One (128 keys, kv head, batch) item, key tile 0 (the longest causal
// query range) first; for each query head of the kv head's group in turn
// (nh / kvh of them: GQA), its query tiles of 64 rows from qt0 to nq.
struct DkdvItem {
  int k0, kh, b, qt0, nq;
  __device__ DkdvItem(int item, int batch, const Geometry& g) {
    const int per = g.kvh * batch, rem = item % per;
    k0 = item / per * kRows;
    kh = rem % g.kvh;
    b = rem / g.kvh;
    nq = (g.sq + kBq - 1) / kBq;
    qt0 = g.causal ? k0 / kBq : 0;
  }
};

// kNorm: #6's statistics (m, l, delta), else #8's and #10's (lse,
// delta). kSeg: segment ids `seg` [b, sq] (keys read seg[:, :sk]).
template <int D, bool kNorm, bool kSeg = false>
__device__ __forceinline__ void dkdv_body(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const Stats& st, const int* __restrict__ seg,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const Geometry& g, int batch) {
  using L = DkdvSmem<D, kSeg>;
  constexpr int kSv = L::kStatRows * kBq;             // a stage's stats
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hop::align1024(smem_raw);
  uint64_t* kv_full = (uint64_t*)(sm + L::kBars);   // [2]
  uint64_t* kv_empty = kv_full + 2;                  // [2]
  uint64_t* q_full = kv_empty + 2;
  uint64_t* q_empty = q_full + L::kStages;
  float* stats = (float*)(sm + L::kStats);           // [stages][rows][64]
  const int n_items = (g.sk + kRows - 1) / kRows * g.kvh * batch;
  const int grp = g.nh / g.kvh;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hop::bar_init(&kv_full[i], 1);
      hop::bar_init(&kv_empty[i], hop::kConsumers);
    }
    for (int s = 0; s < L::kStages; ++s) {
      hop::bar_init(&q_full[s], 32);
      hop::bar_init(&q_empty[s], hop::kConsumers);
    }
    hop::bar_fence_init();
  }
  __syncthreads();

  if (tid >= hop::kConsumers) {
    // producer: for each item, K and V into one of two buffers (lane 0),
    // then per query head of the group and query tile the rows'
    // statistics and ids (all 32 lanes, each arriving on the stage's
    // barrier) and the Q and dO tiles (lane 0). The head loop and the
    // ids need more than the dQ producer's 40 registers a thread.
    reg_dealloc<56>();
    const int lane = tid - hop::kConsumers;
    if (lane >= 32) return;
    hop::Ring ring(L::kStages, 1);
    for (int it = 0, item = blockIdx.x; item < n_items;
         ++it, item += gridDim.x) {
      const DkdvItem w(item, batch, g);
      if (lane == 0) {
        const int kb = it & 1;
        hop::bar_wait(&kv_empty[kb], ((it >> 1) & 1) ^ 1);
        hop::bar_arrive_tx(&kv_full[kb], 2 * L::kKvTile);
        for (int p = 0; p < L::kPanels; ++p) {
          const size_t off = (size_t)kb * L::kKvTile + p * L::kKvPanel;
          hop::load_4d(sm + L::kK + off, &tk, &kv_full[kb], 64 * p, w.kh,
                       w.k0, w.b);
          hop::load_4d(sm + L::kV + off, &tv, &kv_full[kb], 64 * p, w.kh,
                       w.k0, w.b);
        }
      }
      for (int h = w.kh * grp; h < (w.kh + 1) * grp; ++h) {
        const size_t row_base = ((size_t)w.b * g.nh + h) * g.sq;
        for (int qt = w.qt0; qt < w.nq; ++qt, ring.advance()) {
          const int s = ring.stage, q0 = qt * kBq;
          hop::bar_wait(&q_empty[s], ring.phase);
          float* sv = stats + s * kSv;
          for (int r = lane; r < kBq; r += 32) {
            const int i = q0 + r;
            const bool in = i < g.sq;
            sv[r] = in ? st.lse[row_base + i] * kLog2e : INFINITY;
            sv[kBq + r] = in ? st.delta[row_base + i] : 0.f;
            if constexpr (kNorm) sv[2 * kBq + r] =
                in ? recip(st.norm[row_base + i]) : 1.f;
            if constexpr (kSeg) reinterpret_cast<int*>(sv)[3 * kBq + r] =
                in ? seg[(size_t)w.b * g.sq + i] : -1;
          }
          if (lane) {
            hop::bar_arrive(&q_full[s]);
            continue;
          }
          hop::bar_arrive_tx(&q_full[s], 2 * L::kQTile);
          for (int p = 0; p < L::kPanels; ++p) {
            const size_t off = (size_t)s * L::kQTile + p * L::kQPanel;
            hop::load_4d(sm + L::kQ + off, &tq, &q_full[s], 64 * p, h, q0,
                         w.b);
            hop::load_4d(sm + L::kDo + off, &tdo, &q_full[s], 64 * p, h,
                         q0, w.b);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64) of
  // each item; thread t holds keys kw0 + acc_row(t, 0) and 8 further
  const int wg = tid >> 7, t = tid & 127;
  const float sl2 = g.scale * kLog2e;
  reg_alloc<224>();   // 128 x 56 + 256 x 224 = the block's 384 x 168
  hop::Ring ring(L::kStages, 0);
  for (int it = 0, item = blockIdx.x; item < n_items;
       ++it, item += gridDim.x) {
    const DkdvItem w(item, batch, g);
    const int kb = it & 1, kw0 = w.k0 + 64 * wg;
    const int key0 = kw0 + hop::acc_row(t, 0);
    const uint32_t k_addr = hop::smem_addr(sm + L::kK + kb * L::kKvTile) +
                            64 * wg * hop::kRowBytes;
    const uint32_t v_addr = hop::smem_addr(sm + L::kV + kb * L::kKvTile) +
                            64 * wg * hop::kRowBytes;
    // the keys' segment ids (keys past sk: -2, never a row's)
    int seg_k[2] = {0, 0};
    if constexpr (kSeg) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = key0 + 8 * e;
        seg_k[e] = j < g.sk ? seg[(size_t)w.b * g.sq + j] : -2;
      }
    }
    float dk_acc[D / 2], dv_acc[D / 2];
    zero(dk_acc);
    zero(dv_acc);
    hop::bar_wait(&kv_full[kb], (it >> 1) & 1);
    for (int hg = 0; hg < grp; ++hg)
      for (int qt = w.qt0; qt < w.nq; ++qt, ring.advance()) {
        const int s = ring.stage, q0 = qt * kBq;
        hop::bar_wait(&q_full[s], ring.phase);
        if (g.causal && q0 + kBq - 1 < kw0) {   // every row above our keys
          hop::bar_arrive(&q_empty[s]);
          continue;
        }
        const uint32_t q_addr = hop::smem_addr(sm + L::kQ + s * L::kQTile);
        const uint32_t do_addr =
            hop::smem_addr(sm + L::kDo + s * L::kQTile);
        const float* sv = stats + s * kSv;
        // S^T[64 keys x 64 rows] = K Q^T and dP^T = V dO^T
        float p[kBq / 2], dp[kBq / 2];
        issue_ss<kBq, D>(p, k_addr, L::kKvPanel, q_addr, L::kQPanel);
        issue_ss<kBq, D>(dp, v_addr, L::kKvPanel, do_addr, L::kQPanel);
        hop::wait<0>();
        hop::fence_regs(p);
        hop::fence_regs(dp);
        // P^T, packed for dV; then dS^T = P^T (dP^T - delta) scale,
        // packed for dK. A key past the diagonal or of another segment
        // gets p = 0.
        const bool mask = g.causal && q0 < kw0 + 63;
        uint32_t ap[kBq / 16][4], ads[kBq / 16][4];
#pragma unroll
        for (int j = 0; j < kBq / 8; ++j) {
          const int c = 8 * j + 2 * (t & 3);
          const float2 lse2 = *reinterpret_cast<const float2*>(sv + c);
          const float2 dl = *reinterpret_cast<const float2*>(sv + kBq + c);
          float2 inv = make_float2(1.f, 1.f);
          if constexpr (kNorm)
            inv = *reinterpret_cast<const float2*>(sv + 2 * kBq + c);
          int2 rid = make_int2(0, 0);
          if constexpr (kSeg)
            rid = *reinterpret_cast<const int2*>(
                reinterpret_cast<const int*>(sv) + 3 * kBq + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e, col = c + (e & 1);
            const float x =
                exp2f(p[i] * sl2 - ((e & 1) ? lse2.y : lse2.x)) *
                ((e & 1) ? inv.y : inv.x);
            bool hidden = mask && key0 + 8 * (e >> 1) > q0 + col;
            if constexpr (kSeg)
              hidden = hidden || ((e & 1) ? rid.y : rid.x) != seg_k[e >> 1];
            p[i] = hidden ? 0.f : x;
            dp[i] = p[i] * (dp[i] - ((e & 1) ? dl.y : dl.x)) * g.scale;
          }
        }
#pragma unroll
        for (int kk = 0; kk < kBq / 16; ++kk) {
          hop::pack_a(p, kk, ap[kk]);
          hop::pack_a(dp, kk, ads[kk]);
        }
        // dV += P^T dO and dK += dS^T Q (RS, dO and Q MN-major)
        issue_rs<D, kBq>(dv_acc, ap, do_addr, L::kQPanel);
        issue_rs<D, kBq>(dk_acc, ads, q_addr, L::kQPanel);
        hop::wait<0>();
        hop::fence_regs(dv_acc);
        hop::fence_regs(dk_acc);
        fence_a(ap);
        fence_a(ads);
        hop::bar_arrive(&q_empty[s]);
      }
    hop::bar_arrive(&kv_empty[kb]);
    store_rows<D>(dk_acc, dk, t, kw0, g.sk, w.b, w.kh, g.kvh, g.d);
    store_rows<D>(dv_acc, dv, t, kw0, g.sk, w.b, w.kh, g.kvh, g.d);
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// Shared memory: two Q and dO buffers of 128 rows, the ring of K and V
// tiles of kBk keys, each K stage's segment ids (kSeg), the mbarriers.
template <int D, bool kSeg = false>
struct DqSmem {
  static constexpr int kPanels = D / 64;
  static constexpr int kBk = D == 64 ? 128 : 64;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQPanel = kRows * hop::kRowBytes;    // 16 KB
  static constexpr int kQTile = kPanels * kQPanel;
  static constexpr int kKPanel = kBk * hop::kRowBytes;
  static constexpr int kKTile = kPanels * kKPanel;
  static constexpr size_t kQ = 0;
  static constexpr size_t kDo = kQ + 2 * (size_t)kQTile;
  static constexpr size_t kK = kDo + 2 * (size_t)kQTile;
  static constexpr size_t kV = kK + (size_t)kStages * kKTile;
  static constexpr size_t kSegK = kV + (size_t)kStages * kKTile;
  static constexpr size_t kBars =
      kSegK + (kSeg ? (size_t)kStages * kBk * sizeof(int) : 0);
  // q full / empty [2 each], then kv full, kv empty [stages each]
  static constexpr size_t kBytes = kBars + (4 + 2 * kStages) * 8 + 1024;
};

// One (128 rows, head, batch) item, the longest causal rows first; its
// key tiles of kBk, of kv head kh = h / (nh / kvh).
template <int kBk>
struct DqItem {
  int q0, h, kh, b, n_kt;
  __device__ DqItem(int item, int batch, const Geometry& g) {
    const int nq = (g.sq + kRows - 1) / kRows, per = g.nh * batch;
    const int rem = item % per;
    q0 = (nq - 1 - item / per) * kRows;
    h = rem % g.nh;
    b = rem / g.nh;
    kh = h / (g.nh / g.kvh);
    const int nk = (g.sk + kBk - 1) / kBk;
    n_kt = g.causal ? min(nk, (q0 + kRows) / kBk) : nk;
  }
};

// kNorm: #6 (the statistics walk first; writes st), else #8 and #10
// (read st). kSeg: segment ids `seg` [b, sq] (keys read seg[:, :sk]).
template <int D, bool kNorm, bool kSeg = false>
__device__ __forceinline__ void dq_body(const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv,
                                        const CUtensorMap& tdo,
                                        const Stats& st,
                                        const int* __restrict__ seg,
                                        __nv_bfloat16* __restrict__ dq,
                                        const Geometry& g, int batch) {
  using L = DqSmem<D, kSeg>;
  constexpr int kBk = L::kBk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hop::align1024(smem_raw);
  uint64_t* q_full = (uint64_t*)(sm + L::kBars);   // [2]
  uint64_t* q_empty = q_full + 2;                   // [2]
  uint64_t* kv_full = q_empty + 2;
  uint64_t* kv_empty = kv_full + L::kStages;
  int* seg_k = (int*)(sm + L::kSegK);               // [stages][kBk], kSeg
  const int n_items = (g.sq + kRows - 1) / kRows * g.nh * batch;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hop::bar_init(&q_full[i], 1);
      hop::bar_init(&q_empty[i], hop::kConsumers);
    }
    for (int s = 0; s < L::kStages; ++s) {
      hop::bar_init(&kv_full[s], kSeg ? 32 : 1);
      hop::bar_init(&kv_empty[s], hop::kConsumers);
    }
    hop::bar_fence_init();
  }
  __syncthreads();

  if (tid >= hop::kConsumers) {
    // producer: for each item, Q and dO into one of two buffers, then the
    // K and V tiles of the kv head (twice for #6: the statistics walk,
    // then dQ's). Lane 0 of its first warp issues the copies; with
    // segment ids every lane of that warp writes a K tile's ids and
    // arrives on its barrier.
    reg_dealloc<40>();
    const int lane = tid - hop::kConsumers;
    if (lane >= 32 || (!kSeg && lane)) return;
    hop::Ring ring(L::kStages, 1);
    for (int it = 0, item = blockIdx.x; item < n_items;
         ++it, item += gridDim.x) {
      const DqItem<kBk> w(item, batch, g);
      if (lane == 0) {
        const int qb = it & 1;
        hop::bar_wait(&q_empty[qb], ((it >> 1) & 1) ^ 1);
        hop::bar_arrive_tx(&q_full[qb], 2 * L::kQTile);
        for (int p = 0; p < L::kPanels; ++p) {
          const size_t off = (size_t)qb * L::kQTile + p * L::kQPanel;
          hop::load_4d(sm + L::kQ + off, &tq, &q_full[qb], 64 * p, w.h,
                       w.q0, w.b);
          hop::load_4d(sm + L::kDo + off, &tdo, &q_full[qb], 64 * p, w.h,
                       w.q0, w.b);
        }
      }
      for (int pass = kNorm ? 0 : 1; pass < 2; ++pass)
        for (int kt = 0; kt < w.n_kt; ++kt, ring.advance()) {
          const int s = ring.stage, k0 = kt * kBk;
          hop::bar_wait(&kv_empty[s], ring.phase);
          if constexpr (kSeg) {
            int* ids = seg_k + s * kBk;
            for (int j = lane; j < kBk; j += 32)
              ids[j] = k0 + j < g.sk ? seg[(size_t)w.b * g.sq + k0 + j]
                                     : -2;
            if (lane) {
              hop::bar_arrive(&kv_full[s]);
              continue;
            }
          }
          hop::bar_arrive_tx(&kv_full[s], 2 * L::kKTile);
          for (int p = 0; p < L::kPanels; ++p) {
            const size_t off = (size_t)s * L::kKTile + p * L::kKPanel;
            hop::load_4d(sm + L::kK + off, &tk, &kv_full[s], 64 * p, w.kh,
                         k0, w.b);
            hop::load_4d(sm + L::kV + off, &tv, &kv_full[s], 64 * p, w.kh,
                         k0, w.b);
          }
        }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [q0 + 64 wg, q0 + 64 wg + 64) of
  // each item; thread t holds rows row0 and row0 + 8
  const int wg = tid >> 7, t = tid & 127;
  const float sl2 = g.scale * kLog2e;
  const uint32_t k_base = hop::smem_addr(sm + L::kK);
  const uint32_t v_base = hop::smem_addr(sm + L::kV);
  reg_alloc<232>();
  hop::Ring ring(L::kStages, 0);
  for (int it = 0, item = blockIdx.x; item < n_items;
       ++it, item += gridDim.x) {
    const DqItem<kBk> w(item, batch, g);
    const int qb = it & 1;
    const int rows_lo = w.q0 + 64 * wg;
    const int row0 = rows_lo + hop::acc_row(t, 0);
    const uint32_t q_addr = hop::smem_addr(sm + L::kQ + qb * L::kQTile) +
                            64 * wg * hop::kRowBytes;
    const uint32_t do_addr = hop::smem_addr(sm + L::kDo + qb * L::kQTile) +
                             64 * wg * hop::kRowBytes;
    const size_t row_base = ((size_t)w.b * g.nh + w.h) * g.sq;
    // the rows' segment ids (rows past sq: -1, never a key's)
    int seg_r[2] = {0, 0};
    if constexpr (kSeg) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + 8 * r;
        seg_r[r] = i < g.sq ? seg[(size_t)w.b * g.sq + i] : -1;
      }
    }
    float s[kBk / 2], dp[kBk / 2];
    float lse2[2], delta[2], inv_l[2] = {1.f, 1.f};
    hop::bar_wait(&q_full[qb], (it >> 1) & 1);
    if constexpr (kNorm) {
      // the statistics walk: row max m (log2 units), the thread's partial
      // sums l of 2^(s - m) and of 2^(s - m) dP, online in fp32
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      float ed[2] = {0.f, 0.f};
      for (int kt = 0; kt < w.n_kt; ++kt, ring.advance()) {
        const int st_ = ring.stage;
        hop::bar_wait(&kv_full[st_], ring.phase);
        issue_ss<kBk, D>(s, q_addr, L::kQPanel, k_base + st_ * L::kKTile,
                         L::kKPanel);
        issue_ss<kBk, D>(dp, do_addr, L::kQPanel, v_base + st_ * L::kKTile,
                         L::kKPanel);
        hop::wait<0>();
        hop::fence_regs(s);
        hop::fence_regs(dp);
        hop::bar_arrive(&kv_empty[st_]);
        mask_scores<kSeg, kBk>(s, t, kt * kBk, row0, rows_lo,
                               seg_k + st_ * kBk, seg_r, sl2, g);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kBk / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float mu[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], hop::quad_max(mx[r]));
          mu[r] = mn == -INFINITY ? 0.f : mn;
          const float corr = exp2f(m[r] - mu[r]);
          l[r] *= corr;
          ed[r] *= corr;
          m[r] = mn;
        }
#pragma unroll
        for (int i = 0; i < kBk / 2; ++i) {
          const int r = (i >> 1) & 1;
          const float e = exp2f(s[i] - mu[r]);
          l[r] += e;
          ed[r] = fmaf(e, dp[i], ed[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lt = hop::quad_sum(l[r]), et = hop::quad_sum(ed[r]);
        const float m_nat = m[r] * kLn2;
        delta[r] = et / lt;
        lse2[r] = m_nat * kLog2e;
        inv_l[r] = recip(lt);
        const int row = row0 + 8 * r;
        if ((t & 3) == 0 && row < g.sq) {
          st.lse[row_base + row] = m_nat;
          st.norm[row_base + row] = lt;
          st.delta[row_base + row] = delta[r];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const bool in = row < g.sq;
        lse2[r] = in ? st.lse[row_base + row] * kLog2e : INFINITY;
        delta[r] = in ? st.delta[row_base + row] : 0.f;
      }
    }

    float dq_acc[D / 2];
    zero(dq_acc);
    for (int kt = 0; kt < w.n_kt; ++kt, ring.advance()) {
      const int st_ = ring.stage;
      const uint32_t k_addr = k_base + st_ * L::kKTile;
      hop::bar_wait(&kv_full[st_], ring.phase);
      issue_ss<kBk, D>(s, q_addr, L::kQPanel, k_addr, L::kKPanel);
      issue_ss<kBk, D>(dp, do_addr, L::kQPanel, v_base + st_ * L::kKTile,
                       L::kKPanel);
      hop::wait<0>();
      hop::fence_regs(s);
      hop::fence_regs(dp);
      mask_scores<kSeg, kBk>(s, t, kt * kBk, row0, rows_lo,
                             seg_k + st_ * kBk, seg_r, sl2, g);
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p = exp2f(s[i] - lse2[r]) * inv_l[r];
        s[i] = p * (dp[i] - delta[r]) * g.scale;
      }
      uint32_t ads[kBk / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) hop::pack_a(s, kk, ads[kk]);
      issue_rs<D, kBk>(dq_acc, ads, k_addr, L::kKPanel);
      hop::wait<0>();
      hop::fence_regs(dq_acc);
      fence_a(ads);
      hop::bar_arrive(&kv_empty[st_]);
    }
    hop::bar_arrive(&q_empty[qb]);
    store_rows<D>(dq_acc, dq, t, rows_lo, g.sq, w.b, w.h, g.nh, g.d);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The dQ kernel (first: #6's writes the statistics), then the dK/dV
// kernel, of one source's instantiations for head dim D (64 or 128) and
// kSeg (segment ids `seg`, else null). dout is contiguous; q, k, v are
// strided views; k and v have g.kvh heads.
template <int D, bool kSeg, typename DqKernel, typename DkdvKernel>
cudaError_t launch_bwd(DqKernel dq_kernel, DkdvKernel dkdv_kernel,
                       const void* q, const void* k, const void* v,
                       const void* dout, const Stats& st, const int* seg,
                       void* dq, void* dk, void* dv, View qv, View kv,
                       View vv, int b, const Geometry& g,
                       cudaStream_t stream) {
  constexpr int kBk = DqSmem<D>::kBk;
  const View ov{(long long)g.sq * g.nh * g.d, (long long)g.nh * g.d, g.d};
  // dQ: Q, dO in 128 rows, K, V in kBk; dK/dV: K, V in 128, Q, dO in 64
  CUtensorMap m_dq[4], m_kv[4];
  cudaError_t err;
  if ((err = view_map(&m_dq[0], q, qv, g.nh, g.sq, b, g.d, kRows)) ||
      (err = view_map(&m_dq[1], k, kv, g.kvh, g.sk, b, g.d, kBk)) ||
      (err = view_map(&m_dq[2], v, vv, g.kvh, g.sk, b, g.d, kBk)) ||
      (err = view_map(&m_dq[3], dout, ov, g.nh, g.sq, b, g.d, kRows)) ||
      (err = view_map(&m_kv[0], q, qv, g.nh, g.sq, b, g.d, kBq)) ||
      (err = view_map(&m_kv[1], k, kv, g.kvh, g.sk, b, g.d, kRows)) ||
      (err = view_map(&m_kv[2], v, vv, g.kvh, g.sk, b, g.d, kRows)) ||
      (err = view_map(&m_kv[3], dout, ov, g.nh, g.sq, b, g.d, kBq)))
    return err;
  const size_t smem_q = DqSmem<D, kSeg>::kBytes,
               smem_kv = DkdvSmem<D, kSeg>::kBytes;
  if ((err = hop::prepare(dq_kernel, smem_q)) ||
      (err = hop::prepare(dkdv_kernel, smem_kv)))
    return err;
  int grid = 0;
  if ((err = persistent_grid(
           (long long)((g.sq + kRows - 1) / kRows) * g.nh * b, &grid)))
    return err;
  dq_kernel<<<grid, kThreads, smem_q, stream>>>(
      m_dq[0], m_dq[1], m_dq[2], m_dq[3], st, seg, (__nv_bfloat16*)dq, g,
      b);
  if ((err = cudaGetLastError())) return err;
  if ((err = persistent_grid(
           (long long)((g.sk + kRows - 1) / kRows) * g.kvh * b, &grid)))
    return err;
  dkdv_kernel<<<grid, kThreads, smem_kv, stream>>>(
      m_kv[0], m_kv[1], m_kv[2], m_kv[3], st, seg, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, g, b);
  return cudaGetLastError();
}

}  // namespace attn_wg
