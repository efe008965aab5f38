// Ragged paged attention for Hopper (sm_90a): one-token decode and
// multi-token chunked prefill over the paged KV pools of
// paddle_tpu_torch/inference/kv_cache.py.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/paged_attention.py:
//   paged_decode_split_kernel<pool, R> (fp32, bf16, int8 or int4 pools),
//   paged_decode_kernel    <- _decode_kernel (fp pools), launched through
//                             _paged_attention_pallas
//   paged_decode_q_kernel  <- _decode_kernel_q (int8 / int4 pools), the
//                             same call site
//   paged_chunk_wgmma_kernel (bf16 q over bf16, int8 or int4 pools),
//   paged_chunk_kernel     <- _chunk_kernel (fp branch), launched through
//                             _paged_attention_chunk_pallas
//   paged_chunk_q_kernel   <- _chunk_kernel, int8 / int4 branches
// The decode's split-K route, paged_decode_split_kernel, is
// paged_split.cuh's body, and the chunk's bf16 route,
// paged_chunk_wgmma_kernel, is paged_wgmma.cuh's warpgroup body (their
// notes give their designs and what they leave on the table); the
// wrapper's gates (ops/kernels/paged_attention.py `decode_route`,
// `chunk_route`) send every call they refuse to the pages kernels below,
// the ports' first design, on `attend_pages`. The rest of this note is
// about those.
// The plain PyTorch versions (paged_attention_ref /
// paged_attention_chunk_ref in ops/kernels/paged_attention.py) define the
// contract; these kernels follow their arithmetic: fp32 scores, fp32
// online softmax (m, l, acc), fp32 P.V, output cast to q's dtype, and an
// empty row (no visible key) writes zeros, not NaN.
//
// Layouts (one layer):
//   q        decode [b, nh, d]        chunk [b, c, nh, d]
//   pools    [kvh, num_pages, ps, d]  (fp32 or bf16; page 0 is trash)
//            or int8 [kvh, num_pages, ps, d], or uint8 [kvh, num_pages,
//            ps, d/2] packing two int4 values a byte (high nibble the
//            even lane, offset +8), each with fp32 scales [kvh,
//            num_pages, ps], one a cached row
//   tables   [b, pp] int32            (the caller's rows, one per query row)
//   lens     decode seq_lens [b]      chunk start [b]   (int32)
//   out      same shape and dtype as q
// Head h reads KV head h / (nh / kvh) (GQA). Decode is the chunk case
// with c = 1 and start = seq_len - 1: row i of slot b sits at absolute
// position start[b] + i and sees keys at positions <= that.
//
// Design: one block of 128 threads per (slot, kv head, tile of up to 32
// query rows; row r = g * c + i, as the TPU kernel orders its q block).
// The block walks the slot's keys in order, 64 at a time: it looks up
// each key's page in the slot's table, stages the 64 K and V rows in
// shared memory as fp32 (16-byte loads where the row allows), scores its
// rows against them, folds them into a per-row online softmax (one warp
// per row, shuffle reductions), and accumulates P.V in shared memory.
// A block with more than 8 rows (chunk prefill) gives each thread a 4 x 4
// register tile in the scores and in P.V (4 rows by 4 keys, 4 rows by 4
// head dims), so a shared-memory read feeds four FMAs; a block with up to
// 8 (decode: nh / kvh rows) gives each thread whole dot products instead,
// which keeps its threads busy. Keys past the last one any row of the
// tile can see are never read.
//
// Quantized pools dequantize as they are staged: a key's int8 row (d
// bytes) or packed int4 row (d/2 bytes) comes in 16-byte loads, each
// value becomes float (int4: high nibble, then low, minus 8) and is
// multiplied by the row's fp32 scale, one 4-byte load a key for K and
// one for V. The tile in shared memory then holds exactly the fp32
// values the plain version's densify makes, and the rest of the body
// runs unchanged.
//
// What bounds it on the H100: bytes. A slot's visible K/V rows are read
// once per row tile (one tile whenever (nh / kvh) * c <= 32, as at
// decode), 2 * kvh * keys * (d * itemsize + scale bytes) against 3.35
// TB/s: a key costs 4 * d bytes a head in fp32, 2 * d in bf16, d + 4 in
// int8 and d/2 + 4 in int4. The arithmetic, 4 * rows * keys * d flops
// per head, stays far below the card's rate even at chunk prefill.
// What this simple design leaves on the table: one block per (slot, head)
// walks a long context alone (no split-K over the keys, the
// flash-decoding fix for long contexts at small batch, which the split
// route brings, so at decode only b * kvh blocks run); loads are plain
// loads with no cp.async/TMA double
// buffering, so a tile's loads and math do not overlap; the math runs on
// CUDA cores in fp32 rather than wgmma; K/V sit in shared memory as fp32,
// twice the bytes of bf16, which caps blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_split.cuh"
#include "paged_wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowTile = 32;   // rows per block: 8 row lanes x 4
constexpr int kKeyTile = 64;   // keys per step: 16 key lanes x 4
constexpr int kMaxHeadDim = 256;
constexpr size_t kMaxSmemBytes = 232448;   // 227 KB opt-in per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T -> floats
__device__ __forceinline__ void unpack16(uint4 u, const float*, float* o) {
  o[0] = __uint_as_float(u.x);
  o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z);
  o[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(uint4 u, const __nv_bfloat16*,
                                         float* o) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Shared memory (floats): q [32][d+1], K [64][d+1], V [64][d], scores
// [32][65], acc [32][d], m/l/corr [32]. The +1 strides keep column reads
// free of bank conflicts.
size_t smem_bytes(int d) {
  const size_t dp = d + 1;
  const size_t floats = kRowTile * dp + kKeyTile * dp + kKeyTile * d +
                        kRowTile * (kKeyTile + 1) + kRowTile * d +
                        3 * kRowTile;
  return floats * sizeof(float);
}

// Stage keys [k0, k0 + 64) of the slot's table into K/V (fp32); keys at
// or past n_keys are zeros, so masked scores never multiply stale data.
// `vec`: the pools are 16-byte aligned and a row is whole 16-byte words.
template <typename TKV>
__device__ __forceinline__ void stage_keys(
    const TKV* __restrict__ k_pages, const TKV* __restrict__ v_pages,
    const int* __restrict__ pt_row, int h, int num_pages, int ps, int d,
    bool vec, int k0, int n_keys, float* k_s, float* v_s) {
  constexpr int kVec = 16 / sizeof(TKV);
  const int dp = d + 1;
  const size_t head = (size_t)h * num_pages;
  if (vec) {
    const int vecs = d / kVec;
    for (int idx = threadIdx.x; idx < kKeyTile * vecs; idx += kThreads) {
      const int j = idx / vecs, cv = idx - j * vecs;
      const int pos = k0 + j;
      float kf[kVec], vf[kVec];
      if (pos < n_keys) {
        const size_t row =
            ((head + pt_row[pos / ps]) * ps + pos % ps) * d + cv * kVec;
        unpack16(*reinterpret_cast<const uint4*>(k_pages + row), k_pages,
                 kf);
        unpack16(*reinterpret_cast<const uint4*>(v_pages + row), v_pages,
                 vf);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[j * dp + cv * kVec + e] = kf[e];
        v_s[j * d + cv * kVec + e] = vf[e];
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kKeyTile * d; idx += kThreads) {
      const int j = idx / d, dd = idx - j * d;
      const int pos = k0 + j;
      float kf = 0.f, vf = 0.f;
      if (pos < n_keys) {
        const size_t row = ((head + pt_row[pos / ps]) * ps + pos % ps) * d;
        kf = to_f(k_pages[row + dd]);
        vf = to_f(v_pages[row + dd]);
      }
      k_s[j * dp + dd] = kf;
      v_s[j * d + dd] = vf;
    }
  }
}

// 16 packed bytes -> 16 int8 values or 32 int4 values (high nibble
// first), each times the row's scale
template <bool kInt4>
__device__ __forceinline__ void dequant16(uint4 u, float s, float* o) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int by = 0; by < 4; ++by) {
      const uint32_t x = (w[i] >> (8 * by)) & 0xffu;   // little-endian
      if constexpr (kInt4) {
        o[8 * i + 2 * by] = (float)((int)(x >> 4) - 8) * s;
        o[8 * i + 2 * by + 1] = (float)((int)(x & 0xfu) - 8) * s;
      } else {
        o[4 * i + by] = (float)(int8_t)x * s;
      }
    }
  }
}

// The pools a kernel reads, and how a 64-key tile of them is staged into
// shared memory as fp32.
template <typename T>
struct FpPool {
  static constexpr bool kQuantized = false;
  const T* __restrict__ k;
  const T* __restrict__ v;

  __device__ __forceinline__ void stage(const int* __restrict__ pt_row,
                                        int h, int num_pages, int ps, int d,
                                        bool vec, int k0, int n_keys,
                                        float* k_s, float* v_s) const {
    stage_keys<T>(k, v, pt_row, h, num_pages, ps, d, vec, k0, n_keys, k_s,
                  v_s);
  }
};

// int8 rows of d bytes, or int4 rows of d/2 bytes; scales [kvh, P, ps]
// share the pools' row index (h * num_pages + page) * ps + offset.
// `vec`: the pools are 16-byte aligned and a row is whole 16-byte words.
template <bool kInt4>
struct QuantPool {
  static constexpr bool kQuantized = true;
  const uint8_t* __restrict__ k;
  const uint8_t* __restrict__ v;
  const float* __restrict__ ks;
  const float* __restrict__ vs;

  __device__ __forceinline__ void stage(const int* __restrict__ pt_row,
                                        int h, int num_pages, int ps, int d,
                                        bool vec, int k0, int n_keys,
                                        float* k_s, float* v_s) const {
    constexpr int kPerByte = kInt4 ? 2 : 1;
    const int row_bytes = d / kPerByte;
    const int dp = d + 1;
    const size_t head = (size_t)h * num_pages;
    if (vec) {
      constexpr int kVals = 16 * kPerByte;   // values in one 16-byte load
      const int vecs = row_bytes / 16;
      for (int idx = threadIdx.x; idx < kKeyTile * vecs; idx += kThreads) {
        const int j = idx / vecs, cv = idx - j * vecs;
        const int pos = k0 + j;
        float kf[kVals], vf[kVals];
        if (pos < n_keys) {
          const size_t r = (head + pt_row[pos / ps]) * ps + pos % ps;
          const size_t at = r * row_bytes + cv * 16;
          dequant16<kInt4>(*reinterpret_cast<const uint4*>(k + at), ks[r],
                           kf);
          dequant16<kInt4>(*reinterpret_cast<const uint4*>(v + at), vs[r],
                           vf);
        } else {
#pragma unroll
          for (int e = 0; e < kVals; ++e) kf[e] = vf[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < kVals; ++e) {
          k_s[j * dp + cv * kVals + e] = kf[e];
          v_s[j * d + cv * kVals + e] = vf[e];
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < kKeyTile * row_bytes;
           idx += kThreads) {
        const int j = idx / row_bytes, cb = idx - j * row_bytes;
        const int pos = k0 + j;
        float kf[kPerByte] = {}, vf[kPerByte] = {};
        if (pos < n_keys) {
          const size_t r = (head + pt_row[pos / ps]) * ps + pos % ps;
          const uint32_t kb = k[r * row_bytes + cb];
          const uint32_t vb = v[r * row_bytes + cb];
          const float ksc = ks[r], vsc = vs[r];
          if constexpr (kInt4) {
            kf[0] = (float)((int)(kb >> 4) - 8) * ksc;
            kf[1] = (float)((int)(kb & 0xfu) - 8) * ksc;
            vf[0] = (float)((int)(vb >> 4) - 8) * vsc;
            vf[1] = (float)((int)(vb & 0xfu) - 8) * vsc;
          } else {
            kf[0] = (float)(int8_t)kb * ksc;
            vf[0] = (float)(int8_t)vb * vsc;
          }
        }
#pragma unroll
        for (int e = 0; e < kPerByte; ++e) {
          k_s[j * dp + cb * kPerByte + e] = kf[e];
          v_s[j * d + cb * kPerByte + e] = vf[e];
        }
      }
    }
  }
};

// The shared body of all kernels: one (slot, kv head, row tile).
template <typename TQ, typename Pool>
__device__ __forceinline__ void attend_pages(
    const TQ* __restrict__ q, const Pool& pool, TQ* __restrict__ out,
    const int* __restrict__ pt_row, int st, int c, int nh, int kvh, int d,
    int num_pages, int ps, int pp, bool vec, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int grp = nh / kvh;
  const int r0 = blockIdx.z * kRowTile;
  const int R = min(kRowTile, grp * c - r0);
  const int dp = d + 1;
  const int sp = kKeyTile + 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int xl = tid & 15;   // key lane (scores) / head-dim lane (P.V)
  const int yl = tid >> 4;   // row lane: rows yl, yl + 8, yl + 16, yl + 24

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kRowTile * dp;
  float* v_s = k_s + kKeyTile * dp;
  float* s_s = v_s + kKeyTile * d;
  float* acc = s_s + kRowTile * sp;
  float* m_s = acc + kRowTile * d;
  float* l_s = m_s + kRowTile;
  float* c_s = l_s + kRowTile;

  // q row r of the tile: head group g, chunk index i; rows past R are
  // zeros (their lanes compute and never store)
  for (int idx = tid; idx < kRowTile * d; idx += kThreads) {
    const int r = idx / d, dd = idx - r * d;
    float x = 0.f;
    if (r < R) {
      const int row = r0 + r;
      const int g = row / c, i = row - g * c;
      x = to_f(q[(((size_t)b * c + i) * nh + h * grp + g) * d + dd]);
    }
    q_s[r * dp + dd] = x;
    acc[idx] = 0.f;
  }
  if (tid < kRowTile) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  // the largest chunk index in the tile sees the most keys
  const int i_max = (r0 / c != (r0 + R - 1) / c) ? c - 1 : (r0 + R - 1) % c;
  const int n_keys = max(0, min(pp * ps, st + i_max + 1));
  // key pos is visible to row r at or below the row's own position
  auto visible = [&](int r, int pos) {
    return pos <= st + (r0 + r) % c && pos < n_keys;
  };
  // register tiles pay off from 9 rows up; decode has nh / kvh rows
  const bool wide = R > 8;
  __syncthreads();

  for (int k0 = 0; k0 < n_keys; k0 += kKeyTile) {
    pool.stage(pt_row, h, num_pages, ps, d, vec, k0, n_keys, k_s, v_s);
    __syncthreads();

    // scores s[r][j] = q_r . k_j * scale, masked to -inf
    if (wide) {
      // a 4 x 4 register tile a thread: rows yl + 8a by keys xl + 16b
      float s[4][4] = {};
      for (int dd = 0; dd < d; ++dd) {
        float qv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv[a] = q_s[(yl + 8 * a) * dp + dd];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) kv[bb] = k_s[(xl + 16 * bb) * dp + dd];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb)
            s[a][bb] = fmaf(qv[a], kv[bb], s[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = yl + 8 * a;
        if (r >= R) continue;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int j = xl + 16 * bb;
          s_s[r * sp + j] = visible(r, k0 + j) ? s[a][bb] * scale : -INFINITY;
        }
      }
    } else {
      // few rows (decode): one (row, key) dot a thread
      for (int idx = tid; idx < R * kKeyTile; idx += kThreads) {
        const int r = idx / kKeyTile, j = idx - r * kKeyTile;
        const float* qr = q_s + r * dp;
        const float* kr = k_s + j * dp;
        float dot = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < d; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        s_s[r * sp + j] = visible(r, k0 + j) ? dot * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, two keys per lane
    for (int r = warp; r < R; r += kThreads / 32) {
      float* sr = s_s + r * sp;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float e0 = 0.f, e1 = 0.f, corr = 1.f;
      // nothing visible yet keeps the empty state (no NaN from inf - inf)
      if (m_new != -INFINITY) {
        e0 = expf(x0 - m_new);
        e1 = expf(x1 - m_new);
        corr = expf(m_prev - m_new);
      }
      sr[lane] = e0;
      sr[lane + 32] = e1;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P.V
    if (wide) {
      // a 4 x 4 register tile a thread: rows yl + 8a by head dims
      // db + xl + 16e
      for (int db = 0; db < d; db += 64) {
        float o[4][4] = {};
        for (int j = 0; j < kKeyTile; ++j) {
          float pv[4], vv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) pv[a] = s_s[(yl + 8 * a) * sp + j];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int dd = db + xl + 16 * e;
            vv[e] = dd < d ? v_s[j * d + dd] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[a][e] = fmaf(pv[a], vv[e], o[a][e]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = yl + 8 * a;
          if (r >= R) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int dd = db + xl + 16 * e;
            if (dd < d) acc[r * d + dd] = acc[r * d + dd] * c_s[r] + o[a][e];
          }
        }
      }
    } else {
      // few rows: one (row, head dim) output a thread
      for (int idx = tid; idx < R * d; idx += kThreads) {
        const int r = idx / d, dd = idx - r * d;
        const float* pr = s_s + r * sp;
        float o = 0.f;
#pragma unroll 8
        for (int j = 0; j < kKeyTile; ++j) o = fmaf(pr[j], v_s[j * d + dd], o);
        acc[idx] = acc[idx] * c_s[r] + o;
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < R * d; idx += kThreads) {
    const int r = idx / d, dd = idx - r * d;
    const int row = r0 + r;
    const int g = row / c, i = row - g * c;
    const float l = l_s[r];
    out[(((size_t)b * c + i) * nh + h * grp + g) * d + dd] =
        from_f<TQ>(acc[idx] / (l == 0.f ? 1.f : l));
  }
}

// One entry point per pool kind (fp or quantized) and per call shape, so
// a profile tells the four apart; all run attend_pages. `lens` is
// seq_lens (decode: c == 1, a slot's one query at seq_len - 1) or start
// (chunk: c queries at start + i).
#define PAGED_KERNEL(NAME, START, C)                                         \
  template <typename TQ, typename Pool>                                      \
  __global__ void __launch_bounds__(kThreads) NAME(                          \
      const TQ* __restrict__ q, Pool pool, TQ* __restrict__ out,             \
      const int* __restrict__ page_tables, const int* __restrict__ lens,     \
      int c, int nh, int kvh, int d, int num_pages, int ps, int pp, int vec, \
      float scale) {                                                         \
    const int b = blockIdx.x;                                                \
    attend_pages<TQ, Pool>(q, pool, out, page_tables + (size_t)b * pp,       \
                           START, C, nh, kvh, d, num_pages, ps, pp, vec,     \
                           scale);                                           \
  }
PAGED_KERNEL(paged_decode_kernel, lens[b] - 1, 1)
PAGED_KERNEL(paged_decode_q_kernel, lens[b] - 1, 1)
PAGED_KERNEL(paged_chunk_kernel, lens[b], c)
PAGED_KERNEL(paged_chunk_q_kernel, lens[b], c)
#undef PAGED_KERNEL

bool geometry_ok(int b, int c, int nh, int kvh, int d, int num_pages, int ps,
                 int pp) {
  return b > 0 && c > 0 && kvh > 0 && kvh <= 65535 &&
         nh > 0 && nh % kvh == 0 && d > 0 && d <= kMaxHeadDim && ps > 0 &&
         pp > 0 && num_pages > 0 &&
         (long long)(nh / kvh) * c <= 65535LL * kRowTile;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

// the kernel of a pool kind and call shape
template <typename TQ, typename Pool>
auto entry(bool chunk) {
  if constexpr (Pool::kQuantized)
    return chunk ? paged_chunk_q_kernel<TQ, Pool>
                 : paged_decode_q_kernel<TQ, Pool>;
  else
    return chunk ? paged_chunk_kernel<TQ, Pool>
                 : paged_decode_kernel<TQ, Pool>;
}

// `vec`: 16-byte loads of whole rows (row_bytes a multiple of 16 and
// both pools 16-byte aligned); otherwise the scalar staging path
template <typename TQ, typename Pool>
cudaError_t launch(const void* q, const Pool& pool, bool vec, void* out,
                   const int* pt, const int* lens, bool chunk, int b, int c,
                   int nh, int kvh, int d, int num_pages, int ps, int pp,
                   float scale, cudaStream_t stream) {
  const int rows = nh / kvh * c;
  const size_t smem = smem_bytes(d);
  const dim3 grid(b, kvh, (rows + kRowTile - 1) / kRowTile);
  const auto kernel = entry<TQ, Pool>(chunk);
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>((const TQ*)q, pool, (TQ*)out, pt,
                                           lens, c, nh, kvh, d, num_pages,
                                           ps, pp, vec, scale);
  return cudaGetLastError();
}

bool aligned16(const void* a, const void* b) {
  return (((uintptr_t)a | (uintptr_t)b) % 16) == 0;
}

template <typename TQ>
cudaError_t dispatch_kv(const void* q, const void* k, const void* v,
                        void* out, const int* pt, const int* lens, bool chunk,
                        int b, int c, int nh, int kvh, int d, int num_pages,
                        int ps, int pp, float scale, int kv_bf16,
                        cudaStream_t s) {
  if (kv_bf16) {
    const FpPool<__nv_bfloat16> pool{(const __nv_bfloat16*)k,
                                     (const __nv_bfloat16*)v};
    return launch<TQ>(q, pool, d % 8 == 0 && aligned16(k, v), out, pt, lens,
                      chunk, b, c, nh, kvh, d, num_pages, ps, pp, scale, s);
  }
  const FpPool<float> pool{(const float*)k, (const float*)v};
  return launch<TQ>(q, pool, d % 4 == 0 && aligned16(k, v), out, pt, lens,
                    chunk, b, c, nh, kvh, d, num_pages, ps, pp, scale, s);
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     const void* pt, const void* lens, bool chunk, int b,
                     int c, int nh, int kvh, int d, int num_pages, int ps,
                     int pp, float scale, int q_bf16, int kv_bf16,
                     void* stream) {
  if (!geometry_ok(b, c, nh, kvh, d, num_pages, ps, pp))
    return cudaErrorInvalidValue;
  const int* pti = (const int*)pt;
  const int* li = (const int*)lens;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16)
    return dispatch_kv<__nv_bfloat16>(q, k, v, out, pti, li, chunk, b, c, nh,
                                      kvh, d, num_pages, ps, pp, scale,
                                      kv_bf16, s);
  return dispatch_kv<float>(q, k, v, out, pti, li, chunk, b, c, nh, kvh, d,
                            num_pages, ps, pp, scale, kv_bf16, s);
}

template <typename TQ>
cudaError_t dispatch_quant(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, void* out,
                           const int* pt, const int* lens, bool chunk, int b,
                           int c, int nh, int kvh, int d, int num_pages,
                           int ps, int pp, float scale, int int4,
                           cudaStream_t s) {
  const uint8_t* kb = (const uint8_t*)k;
  const uint8_t* vb = (const uint8_t*)v;
  const float* ksf = (const float*)ks;
  const float* vsf = (const float*)vs;
  if (int4) {
    const QuantPool<true> pool{kb, vb, ksf, vsf};
    return launch<TQ>(q, pool, (d / 2) % 16 == 0 && aligned16(k, v), out,
                      pt, lens, chunk, b, c, nh, kvh, d, num_pages, ps, pp,
                      scale, s);
  }
  const QuantPool<false> pool{kb, vb, ksf, vsf};
  return launch<TQ>(q, pool, d % 16 == 0 && aligned16(k, v), out, pt, lens,
                    chunk, b, c, nh, kvh, d, num_pages, ps, pp, scale, s);
}

cudaError_t dispatch_q(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, void* out,
                       const void* pt, const void* lens, bool chunk, int b,
                       int c, int nh, int kvh, int d, int num_pages, int ps,
                       int pp, float scale, int q_bf16, int int4,
                       void* stream) {
  if (!geometry_ok(b, c, nh, kvh, d, num_pages, ps, pp) ||
      (int4 && d % 2))
    return cudaErrorInvalidValue;
  const int* pti = (const int*)pt;
  const int* li = (const int*)lens;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16)
    return dispatch_quant<__nv_bfloat16>(q, k, v, ks, vs, out, pti, li,
                                         chunk, b, c, nh, kvh, d, num_pages,
                                         ps, pp, scale, int4, s);
  return dispatch_quant<float>(q, k, v, ks, vs, out, pti, li, chunk, b, c,
                               nh, kvh, d, num_pages, ps, pp, scale, int4,
                               s);
}

// bf16 q over bf16, int8 or int4 pools (chunk only): paged_wgmma.cuh's
// warpgroup body. D: the head dim padded to 64 or 128; kMode:
// paged_wg::kBf16, kInt8 or kInt4.
template <int D, int kMode>
__global__ void __launch_bounds__(paged_wg::kThreads, 1)
    paged_chunk_wgmma_kernel(const paged_wg::ChunkArgs a) {
  paged_wg::chunk_body<D, kMode>(a);
}

template <int D, int kMode>
cudaError_t launch_wgmma(const paged_wg::ChunkArgs& a, int b,
                         cudaStream_t stream) {
  const size_t smem = paged_wg::ChunkSmem<D, kMode>::kBytes;
  const auto kernel = paged_chunk_wgmma_kernel<D, kMode>;
  const cudaError_t err = hop::prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = a.nh / a.kvh * a.c;
  const dim3 grid(b, a.kvh, (rows + paged_wg::kRows - 1) / paged_wg::kRows);
  kernel<<<grid, paged_wg::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t dispatch_wgmma(const paged_wg::ChunkArgs& a, int b,
                           cudaStream_t stream) {
  return a.d <= 64 ? launch_wgmma<64, kMode>(a, b, stream)
                   : launch_wgmma<128, kMode>(a, b, stream);
}

// The split-K decode (paged_split.cuh) over fp32, bf16, int8 or int4
// pools: kPool a paged_split pool kind, R the query rows a block takes.
template <int kPool, int R>
__global__ void __launch_bounds__(paged_split::kThreads)
    paged_decode_split_kernel(const paged_split::Args a) {
  paged_split::decode_body<kPool, R>(a);
}

template <int kPool, int R>
cudaError_t launch_split(const paged_split::Args& a, int b,
                         cudaStream_t stream) {
  const size_t smem = paged_split::smem_bytes(kPool, a.d, a.ps,
                                              a.nh / a.kvh, a.stages);
  const auto kernel = paged_decode_split_kernel<kPool, R>;
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.kvh * a.chunks, b), paged_split::kThreads, smem,
           stream>>>(a);
  return cudaGetLastError();
}

template <int kPool>
cudaError_t dispatch_split(const paged_split::Args& a, int b,
                           cudaStream_t stream) {
  switch (paged_split::rows_of(a.nh / a.kvh)) {
    case 1: return launch_split<kPool, 1>(a, b, stream);
    case 2: return launch_split<kPool, 2>(a, b, stream);
    case 4: return launch_split<kPool, 4>(a, b, stream);
    default: return launch_split<kPool, 8>(a, b, stream);
  }
}

}  // namespace

// Plain C interface for ctypes. Each returns the cudaError_t of its
// launch (cudaErrorInvalidValue for a geometry the kernels do not take);
// nothing is allocated and nothing synchronises. head_dim is q's (an
// int4 pool row holds d/2 bytes).
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, void* out,
                            const void* page_tables, const void* seq_lens,
                            int b, int nh, int kvh, int d, int num_pages,
                            int ps, int pp, float scale, int q_bf16,
                            int kv_bf16, void* stream) {
  return (int)dispatch(q, k_pages, v_pages, out, page_tables, seq_lens, false,
                       b, 1, nh, kvh, d, num_pages, ps, pp, scale, q_bf16,
                       kv_bf16, stream);
}

extern "C" int paged_chunk(const void* q, const void* k_pages,
                           const void* v_pages, void* out,
                           const void* page_tables, const void* start, int b,
                           int c, int nh, int kvh, int d, int num_pages,
                           int ps, int pp, float scale, int q_bf16,
                           int kv_bf16, void* stream) {
  return (int)dispatch(q, k_pages, v_pages, out, page_tables, start, true, b,
                       c, nh, kvh, d, num_pages, ps, pp, scale, q_bf16,
                       kv_bf16, stream);
}

extern "C" int paged_decode_q(const void* q, const void* k_pages,
                              const void* v_pages, const void* k_scales,
                              const void* v_scales, void* out,
                              const void* page_tables, const void* seq_lens,
                              int b, int nh, int kvh, int d, int num_pages,
                              int ps, int pp, float scale, int q_bf16,
                              int int4, void* stream) {
  return (int)dispatch_q(q, k_pages, v_pages, k_scales, v_scales, out,
                         page_tables, seq_lens, false, b, 1, nh, kvh, d,
                         num_pages, ps, pp, scale, q_bf16, int4, stream);
}

extern "C" int paged_chunk_q(const void* q, const void* k_pages,
                             const void* v_pages, const void* k_scales,
                             const void* v_scales, void* out,
                             const void* page_tables, const void* start,
                             int b, int c, int nh, int kvh, int d,
                             int num_pages, int ps, int pp, float scale,
                             int q_bf16, int int4, void* stream) {
  return (int)dispatch_q(q, k_pages, v_pages, k_scales, v_scales, out,
                         page_tables, start, true, b, c, nh, kvh, d,
                         num_pages, ps, pp, scale, q_bf16, int4, stream);
}

// The bf16 chunk route on warpgroup products (paged_wgmma.cuh): q bf16
// [b, c, nh, d] with d a multiple of 8 up to 128, over bf16 pools (mode
// 0; scales null), int8 (1) or int4 (2) pools with their scales. Rows
// of 4-byte multiples and pools aligned to 4 bytes (a copy takes 16, 8
// or 4 bytes, as the rows and the pools allow); anything else returns
// cudaErrorInvalidValue, and the wrapper's gate keeps it on
// paged_chunk / paged_chunk_q.
extern "C" int paged_chunk_wgmma(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales, void* out,
                                 const void* page_tables, const void* start,
                                 int b, int c, int nh, int kvh, int d,
                                 int num_pages, int ps, int pp, float scale,
                                 int mode, void* stream) {
  if (!geometry_ok(b, c, nh, kvh, d, num_pages, ps, pp) || d % 8 ||
      d > 128 || mode < 0 || mode > 2 ||
      (((uintptr_t)q | (uintptr_t)out) % 16) ||
      (mode && (k_scales == nullptr || v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int row_bytes = mode == paged_wg::kBf16   ? 2 * d
                        : mode == paged_wg::kInt8 ? d
                                                  : d / 2;
  const uintptr_t align = (uintptr_t)k_pages | (uintptr_t)v_pages |
                          (uintptr_t)row_bytes;
  const int cp_bytes = align % 16 == 0 ? 16 : align % 8 == 0 ? 8
                       : align % 4 == 0 ? 4 : 0;
  if (!cp_bytes) return (int)cudaErrorInvalidValue;
  const paged_wg::ChunkArgs a{(const __nv_bfloat16*)q, (__nv_bfloat16*)out,
                              (const unsigned char*)k_pages,
                              (const unsigned char*)v_pages,
                              (const float*)k_scales, (const float*)v_scales,
                              (const int*)page_tables, (const int*)start, c,
                              nh, kvh, d, num_pages, ps, pp, scale,
                              cp_bytes};
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == paged_wg::kBf16)
    return (int)dispatch_wgmma<paged_wg::kBf16>(a, b, s);
  if (mode == paged_wg::kInt8)
    return (int)dispatch_wgmma<paged_wg::kInt8>(a, b, s);
  return (int)dispatch_wgmma<paged_wg::kInt4>(a, b, s);
}

// The dynamic shared memory a paged_chunk_wgmma block launches with at
// head dim d over pools of `mode`.
extern "C" int paged_chunk_wgmma_smem(int d, int mode) {
  using paged_wg::ChunkSmem;
  if (d <= 64)
    return (int)(mode == 0   ? ChunkSmem<64, 0>::kBytes
                 : mode == 1 ? ChunkSmem<64, 1>::kBytes
                             : ChunkSmem<64, 2>::kBytes);
  return (int)(mode == 0   ? ChunkSmem<128, 0>::kBytes
               : mode == 1 ? ChunkSmem<128, 1>::kBytes
                           : ChunkSmem<128, 2>::kBytes);
}

// The split-K decode (paged_split.cuh): q fp32 or bf16 [b, nh, d] with d a
// multiple of 8 up to 256, over pools of kind `pool` (0 fp32, 1 bf16, 2
// int8, 3 int4; the quantized ones with their scales), page bytes whole
// 16-byte words (quantized: ps a multiple of 4) and every pool and scale
// tensor 16-byte aligned. `part`: the [b * kvh * chunks, splits, R, d + 2]
// fp32 scratch (R = paged_split::rows_of(nh / kvh), chunks =
// ceil((nh / kvh) / R), splits = ceil(pp / pages_per_split)); `count`:
// b * kvh * chunks 32-bit counters, 0 before the call and after it.
// Anything else returns cudaErrorInvalidValue, and the wrapper's gate
// keeps it on paged_decode / paged_decode_q.
extern "C" int paged_decode_split(const void* q, const void* k_pages,
                                  const void* v_pages, const void* k_scales,
                                  const void* v_scales, void* out,
                                  const void* page_tables,
                                  const void* seq_lens, void* part,
                                  void* count, int b, int nh, int kvh, int d,
                                  int num_pages, int ps, int pp, float scale,
                                  int q_bf16, int pool, int pages_per_split,
                                  int stages, void* stream) {
  using namespace paged_split;
  if (!geometry_ok(b, 1, nh, kvh, d, num_pages, ps, pp) || d % 8 ||
      d > kMaxHeadDim || pool < kF32 || pool > kInt4 ||
      pages_per_split < 1 || stages < 1 || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  const bool quant = pool >= kInt8;
  const uintptr_t align = (uintptr_t)k_pages | (uintptr_t)v_pages |
                          (uintptr_t)k_scales | (uintptr_t)v_scales;
  const int grp = nh / kvh, rows = rows_of(grp);
  const int chunks = (grp + rows - 1) / rows;
  if ((ps * row_bytes(pool, d)) % 16 || align % 16 ||
      (quant && (ps % 4 || !k_scales || !v_scales)) ||
      kvh * chunks > 65535 || b > 65535 ||
      smem_bytes(pool, d, ps, grp, stages) > (int)kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const Args a{q, out, (const unsigned char*)k_pages,
               (const unsigned char*)v_pages, (const float*)k_scales,
               (const float*)v_scales, (const int*)page_tables,
               (const int*)seq_lens, (float*)part, (unsigned*)count, nh, kvh,
               d, num_pages, ps, pp, pages_per_split,
               (pp + pages_per_split - 1) / pages_per_split, stages, chunks,
               scale, q_bf16};
  cudaStream_t s = (cudaStream_t)stream;
  switch (pool) {
    case kF32: return (int)dispatch_split<kF32>(a, b, s);
    case kBf16: return (int)dispatch_split<kBf16>(a, b, s);
    case kInt8: return (int)dispatch_split<kInt8>(a, b, s);
    default: return (int)dispatch_split<kInt4>(a, b, s);
  }
}

// The dynamic shared memory a paged_decode_split block launches with.
extern "C" int paged_decode_split_smem(int pool, int d, int ps, int grp,
                                       int stages) {
  return paged_split::smem_bytes(pool, d, ps, grp, stages);
}
