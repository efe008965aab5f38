// Flash attention for Hopper (sm_90a): causal or plain softmax attention
// with q, k and v of one head count, forward and backward, on both paths of
// the reference.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   #5 flash_single_fwd_wgmma_kernel (bf16),
//      flash_single_fwd_kernel (fp32) <- _fwd_single_kernel (seq <= 1024)
//   #6 flash_single_dq_wgmma_kernel,
//      flash_single_dkdv_wgmma_kernel (bf16),
//      flash_single_dq_kernel,
//      flash_single_dkdv_kernel (fp32) <- _bwd_single_kernel
//   #7 flash_fwd_wgmma_kernel (bf16),
//      flash_fwd_kernel (fp32)     <- _fwd_kernel (the tiled path)
//   #8 flash_delta_kernel, then
//      flash_dq_wgmma_kernel,
//      flash_dkdv_wgmma_kernel (bf16),
//      flash_dkdv_kernel,
//      flash_dq_kernel (fp32)      <- _bwd_fused_kernel
// The plain PyTorch versions in ops/kernels/flash_attention.py
// (flash_attention_single_ref / flash_attention_single_bwd_ref,
// flash_attention_ref / flash_attention_bwd_ref) define the contract; these
// kernels follow their arithmetic and their bf16 cast points.
//
// Layouts, masking and the tile machinery: attention_tiles.cuh. q, k, v
// [b, s, nh, d] are strided views (unit stride along d), out, dout, dq, dk,
// dv contiguous, lse [b, nh, sq] fp32.
//
// #7 and #8 are the splash kernels' bodies (csrc/splash_attention.cu) with
// kvh = nh and no segment ids: the tiled online softmax casts the
// unnormalised P to the value dtype and divides O by l at the end, and
// returns lse = m + log l (in bf16 the warpgroup forward of
// attention_wgmma.cuh, whose note gives its design, its bound and what it
// leaves on the table; in fp32 attention_tiles.cuh's, one block per 64
// rows); the backward takes lse and out from outside
// (under ring attention they are the global ones, so p = exp(s - lse) sums
// to less than 1 over one key block, and nothing renormalises), computes
// delta = rowsum(dO * O) in fp32 from the given out, and sums dK, dV and dQ
// in fp32, cast once (in bf16 the warpgroup backward of
// attention_wgmma_bwd.cuh, shared with #6; in fp32 splash's bodies).
//
// #5 keeps the single-block kernel's numerics although a 1024 x 1024 fp32
// score row does not fit a block (227 KB, and a 1024-key row is 4 KB of
// registers a row): the keys are walked twice, first for the row max m and
// sum l (online, fp32), then for P = exp(s - m) / l, normalised *before*
// its cast to the value dtype as in the TPU kernel, and O += P V. There is
// no lse. Keeping the two passes keeps the TPU kernel's rounding; the
// extra Q K^T is cheap on the tensor cores.
//   bf16 (flash_single_fwd_wgmma_kernel, on hopper_tiles.cuh): a
//     persistent walk, one block an SM, over work items of (128 query
//     rows, head, batch), longest causal rows first. A block is two
//     consumer warpgroups of 64 rows and one producer warp that keeps
//     128-key tiles in flight in a ring (pass 1 copies K only, pass 2 K
//     and V; TMA straight from the strided views, ragged edges
//     zero-filled) and loads the next item's Q into a second buffer, so
//     an item starts without the latency of a block's first copies. Q sits
//     in shared memory for both passes. S = Q K^T is an SS wgmma into
//     registers (K K-major); pass 1 keeps m and l online in registers, a
//     quad of lanes per row; pass 2 forms P in registers, packs it to the
//     bf16 A registers of an RS wgmma and adds P V (V MN-major) into O in
//     registers, stored once at the end. Nothing of S or P touches shared
//     memory. Key tiles past the diagonal are skipped; only the diagonal
//     and a ragged last tile are masked. The head dim is padded to 64 or
//     128 (the copies zero-fill the padding).
//   fp32 (flash_single_fwd_kernel): tile_mma.cuh's CUDA-core tiles, one
//     block per 64 rows, S and P staged through shared memory.
// #6 recomputes that softmax from q, k, v alone: the dQ kernel first
// walks the key tiles for m, l and delta = sum_j p_j dP_j (the TPU kernel's
// delta, not rowsum(dO * O), which differs once P is rounded), writes them
// to a [3, b, nh, sq] fp32 scratch, then walks them again for dQ; the dK/dV
// kernel, launched after it, reads the scratch and forms
// p = exp(s - m) / l, normalised before its cast as in the TPU kernel.
// In bf16 both are attention_wgmma_bwd.cuh's persistent warpgroup bodies
// (its note gives the design: TMA rings, every score tile in registers,
// dK/dV key-stationary, dQ query-stationary); in fp32 splash's bodies of
// attention_tiles.cuh. Neither route uses float atomics: every sum lives
// in one block in a fixed order, so gradients are bit-reproducible, and
// the [s, s] matrix never reaches device memory.
//
// What bounds them on the H100 (bytes over 3.35 TB/s or operations over
// 989 TFLOP/s, the larger; causal bf16, d 64): #5 at [8, 1024, 32, 64]
// moves q, k, v, out (134 MB, 0.040 ms) for two products over the causal
// pairs (3.4e10 flops, 0.035 ms); #6 does five products (8.6e10 flops,
// 0.087 ms); #7 at [4, 2048, 32, 64] does 6.9e10 flops (0.069 ms) and #8
// 1.7e11 (0.174 ms). What #5 still leaves on the table: S twice (3
// products where the bound counts 2; the exponentials too), the diagonal
// tile's masked half, no overlap of one warpgroup's softmax with its own
// products (the two warpgroups interleave only by chance) and 4-byte
// output stores. The bf16 #6 does 9 products where its bound counts 5 (S
// and dP in the dQ kernel's statistics walk, its dQ walk and the dK/dV
// kernel) and #8 7 (S and dP in both kernels) plus a delta kernel of its
// own; what else they leave on the table is in attention_wgmma_bwd.cuh's
// note. The fp32 routes of #6, #7 and #8 keep splash's list (CUDA cores
// from shared memory, no cp.async/TMA pipelining, 4-warp blocks).

#include "attention_wgmma_bwd.cuh"

namespace {

using attn::Geometry;
using attn::kB;
using attn::kThreads;
using attn::View;
using tile::from_f;

// ---------------------------------------------------------------------------
// #5: the single-block forward, exact softmax in two passes
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_single_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, View qv, View kv, View vv, Geometry g) {
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kB, rows = min(kB, g.sq - q0);
  const int d = g.d;
  const int pd = tile::pitch<T>(d), pp = tile::pitch<T>(kB);
  const int ps = kB + 4, po = d + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(128) unsigned char smem[];
  attn::FwdTiles<T> t(smem, d);

  tile::stage(t.q, pd, q + b * qv.b + q0 * qv.s + h * qv.h, qv.s, kB, rows,
              d);
  for (int idx = tid; idx < kB * d; idx += kThreads)
    t.o[(idx / d) * po + idx % d] = 0.f;
  if (tid < kB) {
    t.m[tid] = -INFINITY;
    t.l[tid] = 0.f;
  }
  const int n_kt = attn::key_tiles(g, q0, rows);

  // pass 1: the row max m and the row sum l of exp(s - m), online in fp32
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB, kr = min(kB, g.sk - k0);
    __syncthreads();   // the last tile's S has been read
    tile::stage(t.k, pd, k + b * kv.b + k0 * kv.s + h * kv.h, kv.s, kB, kr,
                d);
    __syncthreads();
    tile::mma<T, false, true>(t.s, ps, t.q, pd, t.k, pd, kB, kB, d, false);
    __syncthreads();
    for (int r = warp; r < kB; r += kThreads / 32) {
      const int i = q0 + r;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = lane + 32 * e;
        x[e] = attn::visible(g, i, k0 + j, 0, 0) ? t.s[r * ps + j] * g.scale
                                                 : -INFINITY;
      }
      const float m_prev = t.m[r];
      const float m_new = fmaxf(m_prev, tile::warp_max(fmaxf(x[0], x[1])));
      if (m_new != -INFINITY) {            // uniform over the warp
        const float sum =
            tile::warp_sum(expf(x[0] - m_new) + expf(x[1] - m_new));
        if (lane == 0) {
          t.l[r] = expf(m_prev - m_new) * t.l[r] + sum;
          t.m[r] = m_new;
        }
      }
    }
  }

  // pass 2: P = exp(s - m) / l in the value dtype, O += P V
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB, kr = min(kB, g.sk - k0);
    __syncthreads();   // pass 1's stats are final; the last P.V is done
    tile::stage(t.k, pd, k + b * kv.b + k0 * kv.s + h * kv.h, kv.s, kB, kr,
                d);
    tile::stage(t.v, pd, v + b * vv.b + k0 * vv.s + h * vv.h, vv.s, kB, kr,
                d);
    __syncthreads();
    tile::mma<T, false, true>(t.s, ps, t.q, pd, t.k, pd, kB, kB, d, false);
    __syncthreads();
    for (int idx = tid; idx < kB * kB; idx += kThreads) {
      const int r = idx / kB, j = idx - r * kB;
      const float p = attn::visible(g, q0 + r, k0 + j, 0, 0)
                          ? expf(t.s[r * ps + j] * g.scale - t.m[r]) / t.l[r]
                          : 0.f;
      t.p[r * pp + j] = from_f<T>(p);
    }
    __syncthreads();
    tile::mma<T, false, false>(t.o, po, t.p, pp, t.v, pd, kB, d, kB, true);
  }
  __syncthreads();
  for (int idx = tid; idx < rows * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    out[(((size_t)b * g.sq + q0 + r) * g.nh + h) * d + c] =
        from_f<T>(t.o[r * po + c]);
  }
}

// S[64 rows x 128 keys] = Q K^T of one warpgroup (both K-major), scaled
// to log2 units (sl2 = scale * log2 e); keys past sk or the diagonal
// -inf. Only a tile that reaches past the diagonal or the last key is
// masked.
template <int D>
__device__ __forceinline__ void single_fwd_scores(
    float (&s)[64], uint32_t q_addr, uint32_t k_addr, int k0, int rows_lo,
    int row0, int t, float sl2, const Geometry& g) {
  constexpr uint32_t kPanel = attn_wg::kRows * hop::kRowBytes;
  attn_wg::issue_ss<attn_wg::kRows, D>(s, q_addr, kPanel, k_addr, kPanel);
  hop::wait<0>();
  hop::fence_regs(s);
  const int no_seg[2] = {0, 0};
  attn_wg::mask_scores<false>(s, t, k0, row0, rows_lo, nullptr, no_seg, sl2,
                              g);
}

// The bf16 route: see the note at the top. Template D: the head dim padded
// to 64 or 128. Its shared memory is the tiled forward's layout
// (attention_wgmma.cuh) with one ring for K and V: the barrier area has
// room for this kernel's fewer barriers.
template <int D>
__global__ void __launch_bounds__(hop::kThreads, 1)
    flash_single_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tk,
                                  const __grid_constant__ CUtensorMap tv,
                                  __nv_bfloat16* __restrict__ out,
                                  Geometry g, int batch) {
  using L = attn_wg::FwdSmem<D, false>;
  constexpr int kB = attn_wg::kRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hop::align1024(smem_raw);
  uint64_t* q_full = (uint64_t*)(sm + L::kBars);   // [2]
  uint64_t* q_empty = q_full + 2;                   // [2]
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + L::kStages;
  const int n_items = (g.sq + kB - 1) / kB * g.nh * batch;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      hop::bar_init(&q_full[i], 1);
      hop::bar_init(&q_empty[i], hop::kConsumers);
    }
    for (int s = 0; s < L::kStages; ++s) {
      hop::bar_init(&full[s], 1);
      hop::bar_init(&empty[s], hop::kConsumers);
    }
    hop::bar_fence_init();
  }
  __syncthreads();

  if (tid >= hop::kConsumers) {
    // producer: for each item, Q into one of two buffers, then K tiles
    // (pass 1), then K and V tiles (pass 2); it runs into the next item
    // while the consumers finish this one
    if (tid == hop::kConsumers) {
      hop::Ring ring(L::kStages, 1);
      for (int it = 0, item = blockIdx.x; item < n_items;
           ++it, item += gridDim.x) {
        const attn_wg::FwdItem w(item, batch, g);
        const int qb = it & 1;
        hop::bar_wait(&q_empty[qb], ((it >> 1) & 1) ^ 1);
        hop::bar_arrive_tx(&q_full[qb], L::kTile);
        for (int p = 0; p < L::kPanels; ++p)
          hop::load_4d(sm + L::kQ + qb * L::kTile + p * L::kPanel, &tq,
                       &q_full[qb], 64 * p, w.h, w.q0, w.b);
        for (int pass = 0; pass < 2; ++pass)
          for (int kt = 0; kt < w.n_kt; ++kt, ring.advance()) {
            hop::bar_wait(&empty[ring.stage], ring.phase);
            uint64_t* bar = &full[ring.stage];
            hop::bar_arrive_tx(bar, (pass + 1) * L::kTile);
            unsigned char* ks = sm + L::kK + (size_t)ring.stage * L::kTile;
            unsigned char* vs = sm + L::kV + (size_t)ring.stage * L::kTile;
            for (int p = 0; p < L::kPanels; ++p) {
              hop::load_4d(ks + p * L::kPanel, &tk, bar, 64 * p, w.h,
                           kt * kB, w.b);
              if (pass)
                hop::load_4d(vs + p * L::kPanel, &tv, bar, 64 * p, w.h,
                             kt * kB, w.b);
            }
          }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
  // of each item
  const int wg = tid >> 7, t = tid & 127;
  const float sl2 = g.scale * 1.4426950408889634f;   // scale * log2(e)
  const uint32_t k_addr = hop::smem_addr(sm + L::kK);
  hop::Ring ring(L::kStages, 0);
  for (int it = 0, item = blockIdx.x; item < n_items;
       ++it, item += gridDim.x) {
    const attn_wg::FwdItem w(item, batch, g);
    const int qb = it & 1;
    const int rows_lo = w.q0 + 64 * wg;                // the warpgroup's rows
    const int row0 = rows_lo + hop::acc_row(t, 0);     // and row0 + 8
    const uint32_t q_addr = hop::smem_addr(sm + L::kQ + qb * L::kTile) +
                            64 * wg * hop::kRowBytes;
    float s[64];          // S of 64 rows x 128 keys
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    hop::bar_wait(&q_full[qb], (it >> 1) & 1);
    // pass 1: the row max m and the row sum l of exp(s - m), online in
    // fp32 (each thread sums its own columns; the quad's are added at the
    // end). Every row sees key 0 in the first tile, so m is finite from
    // then on.
    for (int kt = 0; kt < w.n_kt; ++kt, ring.advance()) {
      hop::bar_wait(&full[ring.stage], ring.phase);
      single_fwd_scores<D>(s, q_addr, k_addr + ring.stage * L::kTile,
                           kt * kB, rows_lo, row0, t, sl2, g);
      hop::bar_arrive(&empty[ring.stage]);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], hop::quad_max(mx[r]));
        l[r] *= exp2f(m[r] - mn);
        m[r] = mn;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i)
        l[(i >> 1) & 1] += exp2f(s[i] - m[(i >> 1) & 1]);
    }
    const float inv_l[2] = {1.f / hop::quad_sum(l[0]),
                            1.f / hop::quad_sum(l[1])};

    // pass 2: P = exp(s - m) / l packed into the bf16 A registers of an RS
    // product, O += P V (V MN-major)
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    for (int kt = 0; kt < w.n_kt; ++kt, ring.advance()) {
      hop::bar_wait(&full[ring.stage], ring.phase);
      single_fwd_scores<D>(s, q_addr, k_addr + ring.stage * L::kTile,
                           kt * kB, rows_lo, row0, t, sl2, g);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = exp2f(s[i] - m[r]) * inv_l[r];
      }
      uint32_t a[kB / 16][4];   // 16 keys a step
#pragma unroll
      for (int kk = 0; kk < kB / 16; ++kk) hop::pack_a(s, kk, a[kk]);
      const uint32_t v_addr =
          hop::smem_addr(sm + L::kV + (size_t)ring.stage * L::kTile);
      attn_wg::issue_rs<D, kB>(o, a, v_addr, L::kPanel);
      hop::wait<0>();
      hop::fence_regs(o);
      hop::bar_arrive(&empty[ring.stage]);
    }
    hop::bar_arrive(&q_empty[qb]);   // this item's Q is read

    // O is normalised already: one bf16 store per pair of columns
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = row0 + 8 * ((i >> 1) & 1), c = hop::acc_col(t, i);
      if (r < g.sq && c < g.d)
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((size_t)w.b * g.sq + r) * g.nh + w.h) * g.d + c) =
            __floats2bfloat162_rn(o[i], o[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// #6: the single-block backward (softmax recomputed from q, k, v)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_single_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, attn::Stats st, T* __restrict__ dq, View qv,
    View kv, View vv, Geometry g) {
  attn::dq_body<T, true, true>(q, k, v, dout, st, nullptr, dq, qv, kv, vv, g);
}

// bf16: attention_wgmma_bwd.cuh's bodies with #6's statistics (the dQ
// kernel writes m, l and delta; the dK/dV kernel reads them). D: the head
// dim padded to 64 or 128.
template <int D>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    flash_single_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 attn::Stats st, const int* seg,
                                 __nv_bfloat16* __restrict__ dq, Geometry g,
                                 int batch) {
  attn_wg::dq_body<D, true>(tq, tk, tv, tdo, st, nullptr, dq, g, batch);
}

template <int D>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    flash_single_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                   const __grid_constant__ CUtensorMap tk,
                                   const __grid_constant__ CUtensorMap tv,
                                   const __grid_constant__ CUtensorMap tdo,
                                   attn::Stats st, const int* seg,
                                   __nv_bfloat16* __restrict__ dk,
                                   __nv_bfloat16* __restrict__ dv,
                                   Geometry g, int batch) {
  attn_wg::dkdv_body<D, true>(tq, tk, tv, tdo, st, nullptr, dk, dv, g,
                              batch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_single_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, attn::Stats st, T* __restrict__ dk,
    T* __restrict__ dv, View qv, View kv, View vv, Geometry g) {
  attn::dkdv_body<T, true>(q, k, v, dout, st, nullptr, dk, dv, qv, kv, vv, g);
}

// ---------------------------------------------------------------------------
// #7 / #8: the tiled path (the splash bodies, kvh = nh, no segments)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, const int* __restrict__ seg,
    View qv, View kv, View vv, Geometry g) {
  attn::fwd_body<T>(q, k, v, out, lse, seg, qv, kv, vv, g);
}

// bf16: attention_wgmma.cuh's body, kvh = nh and no segment ids (seg is
// null). D: the head dim padded to 64 or 128.
template <int D>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, const int* seg,
                           Geometry g, int batch) {
  attn_wg::fwd_body<D, false>(tq, tk, tv, out, lse, nullptr, g, batch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,
    float* __restrict__ delta, long long n_rows, int sq, int nh, int d) {
  attn::delta_body<T>(out, dout, delta, n_rows, sq, nh, d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, attn::Stats st, const int* __restrict__ seg,
    T* __restrict__ dk, T* __restrict__ dv, View qv, View kv, View vv,
    Geometry g) {
  attn::dkdv_body<T, false>(q, k, v, dout, st, seg, dk, dv, qv, kv, vv, g);
}

// bf16: attention_wgmma_bwd.cuh's bodies from the outside lse and the
// delta of flash_delta_kernel. D: the head dim padded to 64 or 128.
template <int D>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          attn::Stats st, const int* seg,
                          __nv_bfloat16* __restrict__ dq, Geometry g,
                          int batch) {
  attn_wg::dq_body<D, false>(tq, tk, tv, tdo, st, nullptr, dq, g, batch);
}

template <int D>
__global__ void __launch_bounds__(attn_wg::kThreads, 1)
    flash_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            attn::Stats st, const int* seg,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, Geometry g,
                            int batch) {
  attn_wg::dkdv_body<D, false>(tq, tk, tv, tdo, st, nullptr, dk, dv, g, batch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, attn::Stats st, const int* __restrict__ seg,
    T* __restrict__ dq, View qv, View kv, View vv, Geometry g) {
  attn::dq_body<T, false, false>(q, k, v, dout, st, seg, dq, qv, kv, vv, g);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// fp32: tile_mma.cuh's kernel, one block per 64 rows.
cudaError_t fwd_single_fp32(const void* q, const void* k, const void* v,
                            void* out, View qv, View kv, View vv, int b,
                            const Geometry& g, cudaStream_t stream) {
  const size_t smem = attn::fwd_smem<float>(g.d);
  cudaError_t err = tile::prepare(flash_single_fwd_kernel<float>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.sq + kB - 1) / kB, g.nh, b);
  flash_single_fwd_kernel<float><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, qv, kv,
      vv, g);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_single_wgmma(const CUtensorMap (&maps)[3], void* out,
                                int b, const Geometry& g,
                                cudaStream_t stream) {
  const size_t smem = attn_wg::FwdSmem<D, false>::kBytes;
  cudaError_t err = hop::prepare(flash_single_fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = attn_wg::persistent_grid(
      (long long)((g.sq + 127) / 128) * g.nh * b, &grid);
  if (err != cudaSuccess) return err;
  flash_single_fwd_wgmma_kernel<D><<<grid, hop::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)out, g, b);
  return cudaGetLastError();
}

// bf16: the wgmma kernel, over tensor maps of the three strided views.
cudaError_t fwd_single_bf16(const void* q, const void* k, const void* v,
                            void* out, View qv, View kv, View vv, int b,
                            const Geometry& g, cudaStream_t stream) {
  CUtensorMap maps[3];
  const cudaError_t err =
      attn_wg::qkv_maps(maps, q, k, v, qv, kv, vv, b, g);
  if (err != cudaSuccess) return err;
  return g.d <= 64 ? launch_single_wgmma<64>(maps, out, b, g, stream)
                   : launch_single_wgmma<128>(maps, out, b, g, stream);
}

// fp32 #6: tile_mma.cuh's kernels, dQ first (it writes the row stats),
// then dK/dV (which read them).
cudaError_t bwd_single_fp32(const void* q, const void* k, const void* v,
                            const void* dout, float* stats, void* dq,
                            void* dk, void* dv, View qv, View kv, View vv,
                            int b, const Geometry& g, cudaStream_t stream) {
  using T = float;
  const size_t smem_q = attn::bwd_smem<T>(g.d, 1, 3);
  const size_t smem_kv = attn::bwd_smem<T>(g.d, 2, 3);
  cudaError_t err = tile::prepare(flash_single_dq_kernel<T>, smem_q);
  if (err != cudaSuccess) return err;
  err = tile::prepare(flash_single_dkdv_kernel<T>, smem_kv);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)b * g.nh * g.sq;
  const attn::Stats st{stats, stats + n, stats + 2 * n};
  const dim3 grid_q((g.sq + kB - 1) / kB, g.nh, b);
  flash_single_dq_kernel<T><<<grid_q, kThreads, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, st, (T*)dq, qv,
      kv, vv, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((g.sk + kB - 1) / kB, g.nh, b);
  flash_single_dkdv_kernel<T><<<grid_kv, kThreads, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, st, (T*)dk,
      (T*)dv, qv, kv, vv, g);
  return cudaGetLastError();
}

// bf16 #6: the wgmma dQ kernel (which writes the statistics), then the
// wgmma dK/dV kernel.
cudaError_t bwd_single_bf16(const void* q, const void* k, const void* v,
                            const void* dout, float* stats, void* dq,
                            void* dk, void* dv, View qv, View kv, View vv,
                            int b, const Geometry& g, cudaStream_t stream) {
  const size_t n = (size_t)b * g.nh * g.sq;
  const attn::Stats st{stats, stats + n, stats + 2 * n};
  return g.d <= 64 ? attn_wg::launch_bwd<64, false>(
                         flash_single_dq_wgmma_kernel<64>,
                         flash_single_dkdv_wgmma_kernel<64>, q, k, v, dout,
                         st, nullptr, dq, dk, dv, qv, kv, vv, b, g, stream)
                   : attn_wg::launch_bwd<128, false>(
                         flash_single_dq_wgmma_kernel<128>,
                         flash_single_dkdv_wgmma_kernel<128>, q, k, v, dout,
                         st, nullptr, dq, dk, dv, qv, kv, vv, b, g, stream);
}

// bf16 #8: delta = rowsum(dO * O) (flash_delta_kernel), then the wgmma
// dQ and dK/dV kernels.
cudaError_t bwd_bf16(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, float* lse,
                     float* delta, void* dq, void* dk, void* dv, View qv,
                     View kv, View vv, int b, const Geometry& g,
                     cudaStream_t stream) {
  using T = __nv_bfloat16;
  const long long n_rows = (long long)b * g.sq * g.nh;
  const int rows_per_block = kThreads / 32;
  flash_delta_kernel<T>
      <<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block),
         kThreads, 0, stream>>>((const T*)out, (const T*)dout, delta, n_rows,
                                g.sq, g.nh, g.d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const attn::Stats st{lse, nullptr, delta};
  return g.d <= 64 ? attn_wg::launch_bwd<64, false>(
                         flash_dq_wgmma_kernel<64>, flash_dkdv_wgmma_kernel<64>,
                         q, k, v, dout, st, nullptr, dq, dk, dv, qv, kv, vv, b,
                         g, stream)
                   : attn_wg::launch_bwd<128, false>(
                         flash_dq_wgmma_kernel<128>,
                         flash_dkdv_wgmma_kernel<128>, q, k, v, dout, st,
                         nullptr, dq, dk, dv, qv, kv, vv, b, g, stream);
}

Geometry geometry(int sq, int sk, int nh, int d, int causal, float scale) {
  return Geometry{sq, sk, nh, nh, d, causal, scale};
}

}  // namespace

// Plain C interface for ctypes: strides (qb, qs, qh, ...) are element
// strides of the q, k, v views over batch, row and head. Each returns the
// cudaError_t of its launches (cudaErrorInvalidValue for a geometry or a
// shared-memory size the kernels do not take); nothing is allocated and
// nothing synchronises.
extern "C" int flash_fwd_single(const void* q, const void* k, const void* v,
                                void* out, long long qb, long long qs,
                                long long qh, long long kb, long long ks,
                                long long kh, long long vb, long long vs,
                                long long vh, int b, int sq, int sk, int nh,
                                int d, int causal, float scale, int bf16,
                                void* stream) {
  const Geometry g = geometry(sq, sk, nh, d, causal, scale);
  if (!attn::geometry_ok(b, g, false)) return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return (int)fwd_single_bf16(q, k, v, out, qv, kv, vv, b, g, s);
  return (int)fwd_single_fp32(q, k, v, out, qv, kv, vv, b, g, s);
}

// The dynamic shared memory a bf16 single-block forward block launches
// with at head dim d.
extern "C" int flash_fwd_single_bf16_smem(int d) {
  return (int)(d <= 64 ? attn_wg::FwdSmem<64, false>::kBytes
                       : attn_wg::FwdSmem<128, false>::kBytes);
}

// stats: [3, b, nh, sq] fp32 scratch (row max, row sum, delta).
extern "C" int flash_bwd_single(const void* q, const void* k, const void* v,
                                const void* dout, void* stats, void* dq,
                                void* dk, void* dv, long long qb,
                                long long qs, long long qh, long long kb,
                                long long ks, long long kh, long long vb,
                                long long vs, long long vh, int b, int sq,
                                int sk, int nh, int d, int causal,
                                float scale, int bf16, void* stream) {
  const Geometry g = geometry(sq, sk, nh, d, causal, scale);
  if (!attn::geometry_ok(b, g, false)) return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)bwd_single_bf16(q, k, v, dout, (float*)stats, dq, dk, dv, qv,
                                kv, vv, b, g, s);
  return (int)bwd_single_fp32(q, k, v, dout, (float*)stats, dq, dk, dv, qv,
                              kv, vv, b, g, s);
}

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, long long qb, long long qs,
                         long long qh, long long kb, long long ks,
                         long long kh, long long vb, long long vs,
                         long long vh, int b, int sq, int sk, int nh, int d,
                         int causal, float scale, int bf16, void* stream) {
  const Geometry g = geometry(sq, sk, nh, d, causal, scale);
  if (!attn::geometry_ok(b, g, false)) return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return g.d <= 64
               ? (int)attn_wg::launch_fwd<64, false>(
                     flash_fwd_wgmma_kernel<64>, q, k, v, out, (float*)lse,
                     nullptr, qv, kv, vv, b, g, s)
               : (int)attn_wg::launch_fwd<128, false>(
                     flash_fwd_wgmma_kernel<128>, q, k, v, out, (float*)lse,
                     nullptr, qv, kv, vv, b, g, s);
  return (int)attn::launch_fwd<float>(flash_fwd_kernel<float>, q, k, v, out,
                                      (float*)lse, nullptr, qv, kv, vv, b, g,
                                      s);
}

// The dynamic shared memory a bf16 tiled forward block launches with at
// head dim d.
extern "C" int flash_fwd_bf16_smem(int d) {
  return (int)(d <= 64 ? attn_wg::FwdSmem<64, false>::kBytes
                       : attn_wg::FwdSmem<128, false>::kBytes);
}

// lse and out from outside (the forward's, or a ring's global ones); delta:
// [b, nh, sq] fp32 scratch.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* out, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv,
                         long long qb, long long qs, long long qh,
                         long long kb, long long ks, long long kh,
                         long long vb, long long vs, long long vh, int b,
                         int sq, int sk, int nh, int d, int causal,
                         float scale, int bf16, void* stream) {
  const Geometry g = geometry(sq, sk, nh, d, causal, scale);
  if (!attn::geometry_ok(b, g, false)) return (int)cudaErrorInvalidValue;
  const View qv{qb, qs, qh}, kv{kb, ks, kh}, vv{vb, vs, vh};
  cudaStream_t s = (cudaStream_t)stream;
  float* l = const_cast<float*>((const float*)lse);
  if (bf16)
    return (int)bwd_bf16(q, k, v, out, dout, l, (float*)delta, dq, dk, dv, qv,
                         kv, vv, b, g, s);
  return (int)attn::launch_bwd<float>(
      flash_delta_kernel<float>, flash_dkdv_kernel<float>,
      flash_dq_kernel<float>, q, k, v, out, dout, l, nullptr, (float*)delta,
      dq, dk, dv, qv, kv, vv, b, g, s);
}

// The dynamic shared memory a bf16 backward's dQ / dK/dV block (#6's and
// #8's alike) launches with at head dim d.
extern "C" int flash_bwd_dq_bf16_smem(int d) {
  return (int)(d <= 64 ? attn_wg::DqSmem<64>::kBytes
                       : attn_wg::DqSmem<128>::kBytes);
}

extern "C" int flash_bwd_dkdv_bf16_smem(int d) {
  return (int)(d <= 64 ? attn_wg::DkdvSmem<64>::kBytes
                       : attn_wg::DkdvSmem<128>::kBytes);
}
