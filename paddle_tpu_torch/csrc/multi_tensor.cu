// Multi-tensor optimizer kernels for Hopper (sm_90a): the global grad norm
// with the non-finite check, and the whole Adam/AdamW update, each one pass
// over a list of tensors in one launch per dtype group.
//
// Replaces the reference's fused optimizer step, which is XLA code and not
// a Pallas kernel:
//   mt_adam_kernel<P, M>  <- paddle_tpu/optimizer/__init__.py `Adam.
//                            _maybe_fused_step` (:161), the jit of
//                            `_build_fused_fn` (:203) over `_adam_math`
//                            (:79), every parameter in one program;
//   mt_norm_kernel        <- paddle_tpu/nn/clip.py `ClipGradByGlobalNorm.
//                            _global_norm_sq` (:50) and the finiteness
//                            check with the unscale of jit/train_step.py
//                            (:355-369) / amp/grad_scaler.py
//                            `_fused_unscale` (:33).
// The plain PyTorch versions (multi_tensor_norm_ref, multi_tensor_adam_ref
// in ops/kernels/multi_tensor.py) define the contract; these kernels do the
// same arithmetic in the same order, one IEEE operation at a time
// (__fmul_rn / __fadd_rn, so nvcc contracts nothing into an fma the plain
// version does not have).
//
// mt_norm_kernel: over the grads (fp32, bf16 or fp16, a dtype code a
// tensor, so one launch takes them all): found_inf = some element is not
// finite, judged on the grad as stored (still loss-scaled); with an
// inv_scale (a device scalar) each element is first unscaled with the
// reference's rounding, x = (g.float() * inv).to(g.dtype), and written back
// when `write` (the eager GradScaler's unscale_); the fp32 sum of x * x over
// the tensors marked need_clip, each group of 8 squares summed in fp32 and
// the groups in fp64 (so the sum does not drift over a billion terms).
// Its chunks are 8192 elements: a thread takes four groups of 8, 2048
// apart, and issues all four loads before it uses one.
// Each block writes its partial (sum, any non-finite) to scratch; the last
// block of the last launch to finish (an integer counter the wrapper owns,
// which that block wraps back to 0) adds the partials in block order and
// writes stats = (sum, clip scale) and found. The clip scale is the
// reference's min(clip_norm / max(sqrt(sum), 1e-12), 1), NaN kept as NaN.
// No float atomics: a second call is bit-identical.
//
// mt_adam_kernel<P, M>: parameters P (fp32, bf16, fp16), grads P, moments M
// (fp32, bf16, fp16), an fp32 master a tensor where it has one (its
// value is the one updated; the parameter gets it rounded). Per element,
// in registers:
//   g = grad; with inv_scale g = round_P(g * inv); with the clip scale
//   and the tensor's need_clip g = round_P(g * scale)   (clip.py scaled)
//   g += l2 * pv                                        (Adam's L2 term)
//   m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g;  vmax = max(vmax, v)
//   out = pv (1 - lr_t wd) - lr_t (m / bc1) / (sqrt((vmax or v) / bc2) + eps)
// with lr_t = lr * the tensor's lr scale, bc = 1 - beta ** t in fp32 from
// the step counter t (device memory, read as step + 1), and the master,
// the parameter and the moments stored in their own dtypes. When found_inf
// (device memory) is set the kernel writes nothing, not even the counter;
// otherwise the last block of the launch marked `bump` raises the counter.
//
// Layout: a table in device memory, built once per parameter set by the
// wrapper, holds each tensor's static pointers (parameter, master,
// moments), numel, first chunk, lr scale, decoupled decay, L2 coefficient
// and flags; the grads, which move every step (clear_grad frees them), ride
// in the kernel's parameters, up to kMaxTensors a launch (3.5 KB, under the
// 4 KB every toolkit takes). A tensor is cut into chunks of 2048 elements;
// a block walks chunks blockIdx.x, + gridDim.x, ..., finding each one's
// tensor by a binary search over the launch's first chunks in shared
// memory. A thread takes 8 consecutive elements of a chunk: 16-byte loads
// and stores where every pointer of the tensor is 16-byte aligned and the 8
// are in range, element by element otherwise.
//
// What bounds it on the H100: bytes. At GPT-3 1.3B with bf16 parameters,
// fp32 masters and bf16 moments the update reads g 2, master 4, m 2, v 2
// and writes master 4, p 2, m 2, v 2: 20 bytes a parameter, 26 GB, 7.8 ms at
// 3.35 TB/s; the norm reads g once more, 2 bytes. About 15 flops a
// parameter: far under any compute roof. The design keeps every
// intermediate in registers (the per-parameter eager update makes about
// ten passes) and one launch per dtype group instead of about ten a
// parameter.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mt {

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int kChunk = kThreads * kVec;  // elements an Adam chunk
constexpr int kNormGroups = 4;            // a norm chunk: 4 Adam chunks
constexpr int kNormChunk = kChunk * kNormGroups;
constexpr int kMaxTensors = 448;
constexpr int kWarps = kThreads / 32;

enum Dtype { kF32 = 0, kBf16 = 1, kF16 = 2 };
enum Flags { kNeedClip = 1 };

// one tensor of the Adam table (72 bytes; ops/kernels/multi_tensor.py
// `_ADAM_ENTRY` packs it)
struct AdamEntry {
  void* p;
  float* master;  // null: the parameter is its own master
  void* m;
  void* v;
  void* vmax;  // null unless amsgrad
  long long numel;
  int chunk0;  // its first chunk in the launch
  int flags;
  float lr_scale, wd, l2, pad;
};
static_assert(sizeof(AdamEntry) == 72, "AdamEntry layout");

// one tensor of the norm table (24 bytes; `_NORM_ENTRY`)
struct NormEntry {
  long long numel;
  int chunk0;
  int dtype;
  int flags;
  int pad;
};
static_assert(sizeof(NormEntry) == 24, "NormEntry layout");

struct Grads {
  const void* g[kMaxTensors];
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float get(const float* p, long long i) {
    return p[i];
  }
  static __device__ __forceinline__ void put(float* p, long long i, float x) {
    p[i] = x;
  }
  static __device__ __forceinline__ void load8(const float* p, float* x) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  static __device__ __forceinline__ void store8(float* p, const float* x) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
};

template <typename T>
struct Cvt;
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float to(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from(float x) {
    return __float2half_rn(x);
  }
};

// the two 16-bit types: a 16-byte word holds 8 elements
template <typename T>
struct Io {
  static __device__ __forceinline__ float round(float x) {
    return Cvt<T>::to(Cvt<T>::from(x));
  }
  static __device__ __forceinline__ float get(const T* p, long long i) {
    return Cvt<T>::to(p[i]);
  }
  static __device__ __forceinline__ void put(T* p, long long i, float x) {
    p[i] = Cvt<T>::from(x);
  }
  static __device__ __forceinline__ void load8(const T* p, float* x) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = Cvt<T>::to(e[j]);
  }
  static __device__ __forceinline__ void store8(T* p, const float* x) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < kVec; ++j) e[j] = Cvt<T>::from(x[j]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the last of the launch's blocks to get here (an integer counter that the
// last one wraps back to 0); every block must call it
__device__ __forceinline__ bool last_block(unsigned* counter) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(counter, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// the tensor of chunk c: the last one whose first chunk is <= c
__device__ __forceinline__ int find_tensor(const int* chunk0, int n, int c) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (chunk0[mid] <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// the norm
// ---------------------------------------------------------------------------

struct NormArgs {
  const NormEntry* table;
  int n, chunks;
  const float* inv_scale;  // null: no unscale
  int write;               // write the unscaled grads back
  double* part;            // [2, total_parts]: sums, then non-finite flags
  int part_offset, total_parts, final_launch;
  unsigned* counter;
  float* stats;  // (sum of squares, clip scale)
  bool* found;
  int has_clip;
  float clip_norm;
};

// a thread's share of one norm chunk: kNormGroups groups of 8, every load
// issued before the first is used (the norm reads 2 bytes an element and
// does almost nothing with them, so it needs many loads in flight)
template <typename T>
__device__ __forceinline__ void norm_chunk(T* g, long long numel,
                                           long long base, bool vec,
                                           float inv, bool unscale,
                                           bool write, bool clip,
                                           double& acc, int& bad) {
  float x[kNormGroups][kVec];
  int live[kNormGroups];
#pragma unroll
  for (int u = 0; u < kNormGroups; ++u) {
    const long long i = base + (long long)u * kChunk;
    live[u] = (int)max(0LL, min((long long)kVec, numel - i));
    if (vec && live[u] == kVec) {
      Io<T>::load8(g + i, x[u]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        x[u][j] = j < live[u] ? Io<T>::get(g, i + j) : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < kNormGroups; ++u) {
    const long long i = base + (long long)u * kChunk;
#pragma unroll
    for (int j = 0; j < kVec; ++j) bad |= !isfinite(x[u][j]);
    if (unscale) {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        x[u][j] = Io<T>::round(__fmul_rn(x[u][j], inv));
      if (write) {
        if (vec && live[u] == kVec) {
          Io<T>::store8(g + i, x[u]);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            if (j < live[u]) Io<T>::put(g, i + j, x[u][j]);
        }
      }
    }
    if (clip) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        s = __fadd_rn(s, __fmul_rn(x[u][j], x[u][j]));
      acc += (double)s;
    }
  }
}

__global__ void __launch_bounds__(kThreads) mt_norm_kernel(NormArgs a,
                                                           Grads grads) {
  __shared__ int chunk0[kMaxTensors];
  __shared__ double warp_sum[kWarps];
  __shared__ int warp_bad[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < a.n; i += kThreads) chunk0[i] = a.table[i].chunk0;
  __syncthreads();
  const bool unscale = a.inv_scale != nullptr;
  const float inv = unscale ? *a.inv_scale : 1.f;
  double acc = 0.0;
  int bad = 0;
  for (int c = blockIdx.x; c < a.chunks; c += gridDim.x) {
    const int t = find_tensor(chunk0, a.n, c);
    const NormEntry e = a.table[t];
    const long long base =
        (long long)(c - chunk0[t]) * kNormChunk + tid * kVec;
    if (base >= e.numel) continue;
    void* g = const_cast<void*>(grads.g[t]);
    const bool vec = aligned16(g);
    const bool clip = e.flags & kNeedClip;
    const bool write = a.write && unscale;
    if (e.dtype == kBf16)
      norm_chunk((__nv_bfloat16*)g, e.numel, base, vec, inv, unscale, write,
                 clip, acc, bad);
    else if (e.dtype == kF16)
      norm_chunk((__half*)g, e.numel, base, vec, inv, unscale, write, clip,
                 acc, bad);
    else
      norm_chunk((float*)g, e.numel, base, vec, inv, unscale, write, clip,
                 acc, bad);
  }
  // the block's partial: a fixed shuffle tree, then the warps in order
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
    bad |= __shfl_xor_sync(0xffffffffu, bad, o);
  }
  if (lane == 0) {
    warp_sum[warp] = acc;
    warp_bad[warp] = bad;
  }
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    int b = 0;
    for (int w = 0; w < kWarps; ++w) {
      s += warp_sum[w];
      b |= warp_bad[w];
    }
    a.part[a.part_offset + blockIdx.x] = s;
    a.part[a.total_parts + a.part_offset + blockIdx.x] = (double)b;
  }
  if (!a.final_launch || !last_block(a.counter)) return;

  // every launch's partials, in block order
  double s = 0.0;
  int b = 0;
  for (int i = tid; i < a.total_parts; i += kThreads) {
    s += __ldcg(a.part + i);
    b |= __ldcg(a.part + a.total_parts + i) != 0.0;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    b |= __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();
  if (lane == 0) {
    warp_sum[warp] = s;
    warp_bad[warp] = b;
  }
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
    int any = 0;
    for (int w = 0; w < kWarps; ++w) {
      total += warp_sum[w];
      any |= warp_bad[w];
    }
    const float sum = (float)total;
    float scale = 1.f;
    if (a.has_clip) {
      float norm = sqrtf(sum);
      norm = norm < 1e-12f ? 1e-12f : norm;  // NaN stays NaN
      scale = __fdiv_rn(a.clip_norm, norm);
      scale = scale > 1.f ? 1.f : scale;
    }
    a.stats[0] = sum;
    a.stats[1] = scale;
    *a.found = any != 0;
  }
}

// ---------------------------------------------------------------------------
// the Adam update
// ---------------------------------------------------------------------------

struct AdamArgs {
  const AdamEntry* table;
  int n, chunks;
  float lr, b1, b2, omb1, omb2, eps;
  int* step;
  const bool* found;        // null: no gate
  const float* inv_scale;   // null: no unscale
  const float* clip_scale;  // null: no clip
  int bump;
  unsigned* counter;
};

struct Consts {
  float bc1, bc2, eps, b1, b2, omb1, omb2;
};

// one element: g the grad as stored, pv the fp32 value updated; m, v, vm
// in and out
__device__ __forceinline__ float adam_elem(float g, float pv, float& m,
                                           float& v, float& vm, bool ams,
                                           float l2, float lr_t, float decay,
                                           const Consts& k) {
  if (l2 != 0.f) g = __fadd_rn(g, __fmul_rn(l2, pv));
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.omb2, g), g));
  const float m_hat = __fdiv_rn(m, k.bc1);
  float vv = v;
  if (ams) {
    // jnp.maximum / torch.maximum: NaN if either is
    vm = (vm != vm || v != v) ? __fadd_rn(vm, v) : fmaxf(vm, v);
    vv = vm;
  }
  const float v_hat = __fdiv_rn(vv, k.bc2);
  const float upd = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), k.eps));
  return __fsub_rn(__fmul_rn(pv, decay), __fmul_rn(lr_t, upd));
}

template <typename P, typename M>
__global__ void __launch_bounds__(kThreads) mt_adam_kernel(AdamArgs a,
                                                           Grads grads) {
  __shared__ int chunk0[kMaxTensors];
  // the gate: a non-finite step writes nothing (no block reaches the
  // counter either, so it stays 0)
  if (a.found != nullptr && *a.found) return;
  const int tid = threadIdx.x;
  for (int i = tid; i < a.n; i += kThreads) chunk0[i] = a.table[i].chunk0;
  const float t = (float)(*a.step + 1);
  Consts k;
  k.bc1 = __fsub_rn(1.f, powf(a.b1, t));
  k.bc2 = __fsub_rn(1.f, powf(a.b2, t));
  k.eps = a.eps;
  k.b1 = a.b1;
  k.b2 = a.b2;
  k.omb1 = a.omb1;
  k.omb2 = a.omb2;
  const bool unscale = a.inv_scale != nullptr;
  const float inv = unscale ? *a.inv_scale : 1.f;
  const float cs = a.clip_scale ? *a.clip_scale : 1.f;
  __syncthreads();
  for (int c = blockIdx.x; c < a.chunks; c += gridDim.x) {
    const int ti = find_tensor(chunk0, a.n, c);
    const AdamEntry& e = a.table[ti];
    const long long numel = e.numel;
    const long long i = (long long)(c - chunk0[ti]) * kChunk + tid * kVec;
    if (i >= numel) continue;
    const P* g = static_cast<const P*>(grads.g[ti]);
    P* p = static_cast<P*>(e.p);
    float* master = e.master;
    M* m = static_cast<M*>(e.m);
    M* v = static_cast<M*>(e.v);
    M* vmax = static_cast<M*>(e.vmax);
    const bool ams = vmax != nullptr;
    const bool clip = a.clip_scale != nullptr && (e.flags & kNeedClip);
    const float lr_t = __fmul_rn(a.lr, e.lr_scale);
    const float decay = __fsub_rn(1.f, __fmul_rn(lr_t, e.wd));
    const float l2 = e.l2;
    const int live = (int)min((long long)kVec, numel - i);
    const bool vec = live == kVec && aligned16(g) && aligned16(p) &&
                     aligned16(master) && aligned16(m) && aligned16(v) &&
                     aligned16(vmax);
    float gx[kVec], pv[kVec], mx[kVec], vx[kVec], vm[kVec];
    if (vec) {
      Io<P>::load8(g + i, gx);
      if (master) Io<float>::load8(master + i, pv);
      else Io<P>::load8(p + i, pv);
      Io<M>::load8(m + i, mx);
      Io<M>::load8(v + i, vx);
      if (ams) Io<M>::load8(vmax + i, vm);
      else for (int j = 0; j < kVec; ++j) vm[j] = 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool in = j < live;
        gx[j] = in ? Io<P>::get(g, i + j) : 0.f;
        pv[j] = !in ? 0.f : master ? master[i + j] : Io<P>::get(p, i + j);
        mx[j] = in ? Io<M>::get(m, i + j) : 0.f;
        vx[j] = in ? Io<M>::get(v, i + j) : 0.f;
        vm[j] = in && ams ? Io<M>::get(vmax, i + j) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float gj = gx[j];
      if (unscale) gj = Io<P>::round(__fmul_rn(gj, inv));
      if (clip) gj = Io<P>::round(__fmul_rn(gj, cs));
      pv[j] = adam_elem(gj, pv[j], mx[j], vx[j], vm[j], ams, l2, lr_t, decay,
                        k);
    }
    if (vec) {
      if (master) Io<float>::store8(master + i, pv);
      Io<P>::store8(p + i, pv);
      Io<M>::store8(m + i, mx);
      Io<M>::store8(v + i, vx);
      if (ams) Io<M>::store8(vmax + i, vm);
    } else {
      // unrolled with a guard, so the arrays stay in registers
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (j >= live) continue;
        if (master) master[i + j] = pv[j];
        Io<P>::put(p, i + j, pv[j]);
        Io<M>::put(m, i + j, mx[j]);
        Io<M>::put(v, i + j, vx[j]);
        if (ams) Io<M>::put(vmax, i + j, vm[j]);
      }
    }
  }
  // the step's last launch raises the counter once every block has read it
  if (a.bump && last_block(a.counter) && tid == 0) *a.step += 1;
}

template <typename P>
cudaError_t launch_adam(int mdtype, const AdamArgs& a, const Grads& g,
                        int grid, cudaStream_t s) {
  if (mdtype == kBf16)
    mt_adam_kernel<P, __nv_bfloat16><<<grid, kThreads, 0, s>>>(a, g);
  else if (mdtype == kF16)
    mt_adam_kernel<P, __half><<<grid, kThreads, 0, s>>>(a, g);
  else
    mt_adam_kernel<P, float><<<grid, kThreads, 0, s>>>(a, g);
  return cudaGetLastError();
}

bool fill_grads(Grads& g, const void* const* ptrs, int n) {
  if (n <= 0 || n > kMaxTensors || ptrs == nullptr) return false;
  for (int i = 0; i < n; ++i) g.g[i] = ptrs[i];
  return true;
}

}  // namespace mt

using namespace mt;

extern "C" int mt_max_tensors() { return kMaxTensors; }
extern "C" int mt_chunk() { return kChunk; }
extern "C" int mt_norm_chunk() { return kNormChunk; }

// Blocks of each kernel an SM holds at once: the wrappers size the grid
// to fill the card once (the blocks walk their chunks in a loop).
extern "C" int mt_norm_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mt_norm_kernel,
                                                    kThreads, 0))
    return -1;
  return n;
}

template <typename P, typename M>
int adam_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, mt_adam_kernel<P, M>, kThreads, 0))
    return -1;
  return n;
}

template <typename P>
int adam_blocks_per_sm(int mdtype) {
  if (mdtype == kBf16) return adam_blocks_per_sm<P, __nv_bfloat16>();
  if (mdtype == kF16) return adam_blocks_per_sm<P, __half>();
  return adam_blocks_per_sm<P, float>();
}

extern "C" int mt_adam_blocks_per_sm(int pdtype, int mdtype) {
  if (pdtype == kBf16) return adam_blocks_per_sm<__nv_bfloat16>(mdtype);
  if (pdtype == kF16) return adam_blocks_per_sm<__half>(mdtype);
  return adam_blocks_per_sm<float>(mdtype);
}

// The norm over `n` grads (`grads`: a host array of their pointers) of one
// launch; `table` its NormEntry rows in device memory. `part` holds
// [2, total_parts] fp64; this launch writes its `grid` partials at
// part_offset, and the launch marked final_launch combines them all.
extern "C" int mt_norm(const void* table, const void* const* grads, int n,
                       int chunks, int grid, const void* inv_scale, int write,
                       void* part, int part_offset, int total_parts,
                       int final_launch, void* counter, void* stats,
                       void* found, int has_clip, float clip_norm,
                       void* stream) {
  Grads g;
  if (!fill_grads(g, grads, n) || chunks <= 0 || grid <= 0 ||
      part_offset + grid > total_parts)
    return (int)cudaErrorInvalidValue;
  NormArgs a;
  a.table = (const NormEntry*)table;
  a.n = n;
  a.chunks = chunks;
  a.inv_scale = (const float*)inv_scale;
  a.write = write;
  a.part = (double*)part;
  a.part_offset = part_offset;
  a.total_parts = total_parts;
  a.final_launch = final_launch;
  a.counter = (unsigned*)counter;
  a.stats = (float*)stats;
  a.found = (bool*)found;
  a.has_clip = has_clip;
  a.clip_norm = clip_norm;
  mt_norm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, g);
  return (int)cudaGetLastError();
}

// One launch of the Adam update over `n` tensors of one (parameter,
// moment) dtype group: pdtype / mdtype are Dtype codes.
extern "C" int mt_adam(int pdtype, int mdtype, const void* table,
                       const void* const* grads, int n, int chunks, int grid,
                       float lr, float b1, float b2, float omb1, float omb2,
                       float eps, void* step, const void* found,
                       const void* inv_scale, const void* clip_scale,
                       int bump, void* counter, void* stream) {
  Grads g;
  if (!fill_grads(g, grads, n) || chunks <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  AdamArgs a;
  a.table = (const AdamEntry*)table;
  a.n = n;
  a.chunks = chunks;
  a.lr = lr;
  a.b1 = b1;
  a.b2 = b2;
  a.omb1 = omb1;
  a.omb2 = omb2;
  a.eps = eps;
  a.step = (int*)step;
  a.found = (const bool*)found;
  a.inv_scale = (const float*)inv_scale;
  a.clip_scale = (const float*)clip_scale;
  a.bump = bump;
  a.counter = (unsigned*)counter;
  cudaStream_t s = (cudaStream_t)stream;
  if (pdtype == kBf16) return (int)launch_adam<__nv_bfloat16>(mdtype, a, g, grid, s);
  if (pdtype == kF16) return (int)launch_adam<__half>(mdtype, a, g, grid, s);
  return (int)launch_adam<float>(mdtype, a, g, grid, s);
}
