// One-token paged attention as a split-K kernel with bulk page copies
// (sm_90a): TPU kernels #1 (`_decode_kernel`, fp pools) and #2
// (`_decode_kernel_q`, int8 / int4 pools) of
// paddle_tpu/ops/pallas/paged_attention.py, both launched there through
// `_paged_attention_pallas`. paged_attention.cu wraps `decode_body` as
// paged_decode_split_kernel<pool, R>; the wrapper's gate
// (ops/kernels/paged_attention.py `decode_route`) sends it fp32 or bf16
// queries over fp32, bf16, int8 or int4 pools with head dims a multiple
// of 8 up to 256, pages whose bytes are whole 16-byte words and pools
// (and scales) on 16-byte boundaries; every other decode call stays on
// paged_attention.cu's `attend_pages` (paged_decode_kernel /
// paged_decode_q_kernel).
//
// The contract is the plain version's (paged_attention_ref, the
// transcription of paged_attention_xla): slot b's query row of head h
// sees the first min(seq_len[b], pp * ps) keys of its page table through
// kv head h / (nh / kvh); s = q . k * scale in fp32 (a quantized key is
// int * its row's scale), softmax in fp32 in natural units (expf), P kept
// in fp32 for P.V (v dequantized the same way), out in q's dtype; an
// empty slot writes exact zeros.
//
// What bounds it on the H100: bytes. A head reads each visible key's K and
// V row once (2 d bytes each in bf16, d + 4 in int8, d / 2 + 4 in int4),
// against 4 rows x keys x d flops a head: about 1 flop a byte, far under
// the tensor cores' ridge. So the design buys memory parallelism, not
// products:
//   * Split-K over the keys (flash-decoding). The grid is (split, kv head
//     x row chunk, slot); a split covers `pages_per_split` pages of the
//     slot's table (about 128 keys), and the wrapper sizes the grid from
//     the table's width alone, never from seq_lens (no host sync; the
//     call can be captured in a CUDA graph). A block reads its slot's
//     length and leaves at once when its split holds no live key.
//   * Bulk copies of whole pages. A pool page of one kv head is
//     contiguous (ps rows of K, of V, and of each fp32 scale), so one
//     thread moves it with one 1-D bulk copy (hop::load_1d) into a ring of
//     up to four stages, each with its mbarrier; pages past the split's
//     last live key are never copied. The thread refills a stage once
//     every thread has read it.
//   * Math on CUDA cores in fp32, from the pool's own type in shared
//     memory. A group of Gp threads (d / 8 rounded up to a power of two)
//     takes a key: each thread holds 8 head dims of every query row in
//     registers and widens 8 values of the key's row as it reads them
//     (bf16 by a shift, int8 and int4 by a convert: high nibble the even
//     lane, minus 8); the dot is finished by shuffles inside the group.
//     Each group keeps its own online softmax (m, l, and 8 dims of acc a
//     row) over the keys it takes, so the key loop needs no barrier but
//     the stage's. A quantized key's scale multiplies its score, and
//     its v scale multiplies P before P.V.
//   * GQA: a block takes up to 8 query rows of one kv head (R = 1, 2, 4
//     or 8 rows, the group rounded up; larger groups take several row
//     chunks), so K and V are read once per 8 rows.
//   * The merge runs in the same launch. The groups of a block merge in
//     shared memory in group order. A slot with one live split writes out
//     = acc / l at once. Otherwise each split writes its (m, l, acc[d]) a
//     row to scratch, and the last live split of its (slot, kv head, row
//     chunk) to finish, found by an integer counter in a device buffer the
//     wrapper owns (atomicInc, which the last split wraps back to 0; one
//     buffer per device and stream, and a CUDA-graph capture's own),
//     merges all of them in split order and writes out. Only that counter
//     is atomic; every float sum runs in a fixed order, so a second call
//     is bit-identical.
// What it leaves on the table: a stage is refilled only after the whole
// block has read it (a __syncthreads a page); the math is one key a group
// at a time with two exponentials a key and row; the last split's merge
// reads the other splits' partials back from L2.
#pragma once

#include "hopper_tiles.cuh"

namespace paged_split {

constexpr int kThreads = 128;
constexpr int kVec = 8;            // head dims a thread holds
constexpr int kMaxStages = 4;
constexpr int kMaxRows = 8;        // query rows a block takes at most

// Pool kinds.
constexpr int kF32 = 0, kBf16 = 1, kInt8 = 2, kInt4 = 3;

struct Args {
  const void* q;                 // [b, nh, d] fp32 or bf16
  void* out;                     // like q
  const unsigned char* k;        // [kvh, num_pages, ps, row bytes]
  const unsigned char* v;
  const float* ks;               // [kvh, num_pages, ps] (quantized pools)
  const float* vs;
  const int* pt;                 // [b, pp]
  const int* lens;               // [b]
  float* part;                   // [units, splits, R, d + 2]
  unsigned* count;               // [units], 0 between calls
  int nh, kvh, d, num_pages, ps, pp;
  int pages_per_split, splits, stages, chunks;
  float scale;
  int q_bf16;
};

__host__ __device__ inline int row_bytes(int pool, int d) {
  return pool == kF32 ? 4 * d : pool == kBf16 ? 2 * d
         : pool == kInt8 ? d : d / 2;
}

// Rows a block takes for a head group of `grp` query heads.
__host__ __device__ inline int rows_of(int grp) {
  return grp <= 1 ? 1 : grp <= 2 ? 2 : grp <= 4 ? 4 : kMaxRows;
}

// Threads a key takes: d / 8 rounded up to a power of two (up to 32).
__host__ __device__ inline int group_of(int d) {
  int g = 1;
  while (g < d / kVec) g <<= 1;
  return g;
}

__host__ __device__ inline int stage_bytes(int pool, int d, int ps) {
  return 2 * ps * row_bytes(pool, d) + (pool >= kInt8 ? 8 * ps : 0);
}

// The reduction area (per key group: m, l [R] and acc [R][d]), after the
// ring; then the stages' mbarriers and the last-split flag.
__host__ __device__ inline int red_offset(int pool, int d, int ps,
                                          int stages) {
  return stages * stage_bytes(pool, d, ps);
}
__host__ __device__ inline int bar_offset(int pool, int d, int ps, int grp,
                                          int stages) {
  const int red = kThreads / group_of(d) * rows_of(grp) * (d + 2) * 4;
  return (red_offset(pool, d, ps, stages) + red + 7) / 8 * 8;
}
__host__ __device__ inline int smem_bytes(int pool, int d, int ps, int grp,
                                          int stages) {
  return bar_offset(pool, d, ps, grp, stages) + 8 * stages + 16;
}

// 8 values of a key's row (head dims 8 g ...), widened to fp32: the
// integers themselves for quantized pools (their scale multiplies later).
template <int kPool>
__device__ __forceinline__ void widen(const unsigned char* row, int g,
                                      float (&x)[kVec]) {
  if constexpr (kPool == kF32) {
    const float4 a = *reinterpret_cast<const float4*>(row + g * 32);
    const float4 b = *reinterpret_cast<const float4*>(row + g * 32 + 16);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (kPool == kBf16) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + g * 16);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (kPool == kInt8) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + g * 8);
#pragma unroll
    for (int by = 0; by < 4; ++by) {
      x[by] = (float)(int8_t)(u.x >> (8 * by));
      x[4 + by] = (float)(int8_t)(u.y >> (8 * by));
    }
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(row + g * 4);
#pragma unroll
    for (int by = 0; by < 4; ++by) {
      const int byte = (u >> (8 * by)) & 0xff;
      x[2 * by] = (float)((byte >> 4) - 8);
      x[2 * by + 1] = (float)((byte & 15) - 8);
    }
  }
}

// One thread copies a pool page (K, V and, for quantized pools, both scale
// rows; `page` = kv head * num_pages + physical page) into a stage, one
// 1-D bulk copy each, counted on the stage's barrier.
template <bool kQuant>
__device__ __forceinline__ void copy_page(const Args& a, unsigned char* st,
                                          uint64_t* bar, size_t page, int pb,
                                          int sb) {
  hop::bar_arrive_tx(bar, sb);
  hop::load_1d(st, a.k + page * pb, pb, bar);
  hop::load_1d(st + pb, a.v + page * pb, pb, bar);
  if constexpr (kQuant) {
    hop::load_1d(st + 2 * pb, a.ks + page * a.ps, 4 * a.ps, bar);
    hop::load_1d(st + 2 * pb + 4 * a.ps, a.vs + page * a.ps, 4 * a.ps, bar);
  }
}

// out[at] = x in q's dtype.
__device__ __forceinline__ void store(const Args& a, size_t at, float x) {
  if (a.q_bf16)
    ((__nv_bfloat16*)a.out)[at] = __float2bfloat16(x);
  else
    ((float*)a.out)[at] = x;
}

// One (split, kv head and row chunk, slot) block.
template <int kPool, int R>
__device__ __forceinline__ void decode_body(const Args& a) {
  constexpr bool kQuant = kPool >= kInt8;
  extern __shared__ unsigned char smem_raw[];   // 16-byte aligned
  unsigned char* smem = smem_raw;
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / a.chunks, chunk = blockIdx.y % a.chunks;
  const int grp = a.nh / a.kvh, r0 = chunk * R;
  const int rows = min(R, grp - r0);
  const int tid = threadIdx.x, d = a.d, ps = a.ps;
  const size_t head0 = (size_t)b * a.nh + h * grp + r0;   // first q row
  const int len = max(0, min(a.lens[b], a.pp * ps));
  const int span = a.pages_per_split * ps;                // keys a split
  const int live = (len + span - 1) / span;
  if (split >= max(live, 1)) return;                      // no live key
  if (live == 0) {                                        // empty slot
    for (int i = tid; i < rows * d; i += kThreads)
      store(a, head0 * d + i, 0.f);
    return;
  }

  const int rb = row_bytes(kPool, d), pb = ps * rb;
  const int sb = stage_bytes(kPool, d, ps), stages = a.stages;
  const int gp = group_of(d), kp = kThreads / gp;   // lanes a key, keys
  const int g = tid % gp, kg = tid / gp;
  const bool on = g * kVec < d;                     // holds head dims
  uint64_t* full =
      (uint64_t*)(smem + bar_offset(kPool, d, ps, grp, stages));
  int* last = (int*)(full + stages);
  const int p0 = split * a.pages_per_split;
  const int np = min(a.pages_per_split, (len + ps - 1) / ps - p0);
  const int* pt = a.pt + (size_t)b * a.pp + p0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) hop::bar_init(&full[s], 1);
    hop::bar_fence_init();
    for (int i = 0; i < min(stages, np); ++i)
      copy_page<kQuant>(a, smem + i * sb, &full[i],
                        (size_t)h * a.num_pages + pt[i], pb, sb);
  }

  // q rows in registers (zero past the chunk's rows and past d)
  float q[R][kVec], acc[R][kVec], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      acc[r][e] = 0.f;
      float x = 0.f;
      if (on && r < rows) {
        const size_t at = (head0 + r) * d + g * kVec + e;
        x = a.q_bf16
                ? __bfloat162float(((const __nv_bfloat16*)a.q)[at])
                : ((const float*)a.q)[at];
      }
      q[r][e] = x;
    }
  }
  __syncthreads();   // the barriers are initialised

  for (int i = 0; i < np; ++i) {
    const unsigned char* st = smem + (i % stages) * sb;
    hop::bar_wait(&full[i % stages], (i / stages) & 1);
    const float* kscale = (const float*)(st + 2 * pb);
    const float* vscale = kscale + ps;
    // keys of this page the slot sees; every group runs the same trips,
    // so the shuffles see whole warps
    const int keys = min(ps, len - (p0 + i) * ps);
    for (int j0 = 0; j0 < keys; j0 += kp) {
      const int j = j0 + kg;
      const bool key = j < keys;
      float kx[kVec], vx[kVec];
      if (key && on) {
        widen<kPool>(st + j * rb, g, kx);
        widen<kPool>(st + pb + j * rb, g, vx);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kx[e] = vx[e] = 0.f;
      }
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(q[r][e], kx[e], dot);
        for (int o = gp >> 1; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[r] = dot;
      }
      if (!key) continue;
      const float ksc = kQuant ? kscale[j] * a.scale : a.scale;
      const float vsc = kQuant ? vscale[j] : 1.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = s[r] * ksc;
        const float m_new = fmaxf(m[r], x);
        const float corr = expf(m[r] - m_new);   // 0 at the first key
        const float p = expf(x - m_new);
        l[r] = l[r] * corr + p;
        m[r] = m_new;
        const float pv = p * vsc;
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[r][e] = fmaf(pv, vx[e], acc[r][e] * corr);
      }
    }
    __syncthreads();   // every thread has read the stage
    if (tid == 0 && i + stages < np) {
      hop::fence_async_smem();
      copy_page<kQuant>(a, smem + (i % stages) * sb, &full[i % stages],
                        (size_t)h * a.num_pages + pt[i + stages], pb, sb);
    }
  }

  // merge the key groups in group order: (M, L, A[d]) a row
  float* red_m = (float*)(smem + red_offset(kPool, d, ps, stages));
  float* red_l = red_m + kp * R;
  float* red_acc = red_l + kp * R;                  // [kp][R][d]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (g == 0) {
      red_m[kg * R + r] = m[r];
      red_l[kg * R + r] = l[r];
    }
    if (on)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        red_acc[(kg * R + r) * d + g * kVec + e] = acc[r][e];
  }
  __syncthreads();
  float* part = a.part +
                (((size_t)blockIdx.y + (size_t)b * gridDim.y) * a.splits +
                 split) * R * (d + 2);
  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d, dim = i - r * d;
    float mx = -INFINITY;
    for (int k = 0; k < kp; ++k) mx = fmaxf(mx, red_m[k * R + r]);
    float sum = 0.f, o = 0.f;
    for (int k = 0; k < kp; ++k) {
      const float w = expf(red_m[k * R + r] - mx);   // 0 for a keyless group
      sum = fmaf(w, red_l[k * R + r], sum);
      o = fmaf(w, red_acc[(k * R + r) * d + dim], o);
    }
    if (live == 1) {
      store(a, head0 * d + i, o / sum);
    } else {
      float* rp = part + (size_t)r * (d + 2);
      if (dim == 0) {
        rp[0] = mx;
        rp[1] = sum;
      }
      rp[2 + dim] = o;
    }
  }
  if (live == 1) return;

  // the last live split of this (slot, kv head, row chunk) merges
  const size_t unit = (size_t)b * gridDim.y + blockIdx.y;
  __threadfence();
  __syncthreads();
  // atomicInc wraps to 0 at live - 1: the last split resets the counter
  if (tid == 0) *last = atomicInc(&a.count[unit], live - 1) == live - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* parts = a.part + unit * a.splits * R * (d + 2);
  const size_t stride = (size_t)R * (d + 2);
  for (int i = tid; i < rows * d; i += kThreads) {
    const int r = i / d, dim = i - r * d;
    const float* rp = parts + (size_t)r * (d + 2);
    float mx = -INFINITY;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, __ldcg(rp + s * stride));
    float sum = 0.f, o = 0.f;
    for (int s = 0; s < live; ++s) {
      const float* sp = rp + s * stride;
      const float w = expf(__ldcg(sp) - mx);
      sum = fmaf(w, __ldcg(sp + 1), sum);
      o = fmaf(w, __ldcg(sp + 2 + dim), o);
    }
    store(a, head0 * d + i, o / sum);
  }
}

}  // namespace paged_split
