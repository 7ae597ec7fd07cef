// Flash GQA attention over the contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_gqa_attention` of the JAX package
// (llm_based_apache_spark_optimization_tpu/ops/pallas/attention.py): its
// prefill body `_flash_kernel` and its KV-head-folded decode body
// `_make_decode_kernel(dequant=False)`. Same contract:
//
//   q [B, T, N, H] (strided), k and v [B, K, S, H] contiguous, q_positions
//   [B, T] i32, kv_lens [B] i32 (clipped to [0, S]) -> out [B, T, N, H].
//   Key slot s is visible to the query at position p iff s <= p,
//   s < kv_lens[b] and, with a window w > 0, p - s < w. Scale H**-0.5.
//   f32 online softmax; a row with no visible key returns exact zeros.
//   Value rows past the live length are never read (zeros stand in), so
//   garbage or NaN in dead cache slots cannot leak through 0 * NaN.
//
// Element types: bf16 in and out (the serving path), or f32 in and out (for
// tight comparison with the plain version). Head dims 64 and 128.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16):
//   decode (T == 1): the live K + V bytes, sum_b min(S, kv_lens[b]) * K * H
//     * 2 * itemsize, over 3.35 TB/s: a memory-bound read.
//   prefill (T > 1): the larger of those bytes over 3.35 TB/s and the
//     visible (row, key) pairs * 4 * H FLOPs over 989 TFLOP/s.
//
// Design (a first, simple kernel: scalar FMA in f32, no tensor cores, no
// TMA, no wgmma):
//   * Row fold. The G query heads of one KV head become rows r = g*T + t,
//     read from q through its strides (no transposed copy). One K/V tile in
//     shared memory serves all G heads, so K/V are read once per KV head,
//     never once per query head: that is the byte saving decode is bound by.
//   * Grid. One block per (b, kv head, tile of BR rows). Prefill uses
//     BR = 16; decode uses BR = the next power of two >= G (up to 16), so
//     one block holds all G rows of a (b, kv head).
//   * KV loop. A block walks KV tiles of 64 slots from the first slot its
//     rows' window can see (0 without a window) to min(kv_lens[b],
//     max position in the tile + 1). That loop replaces the TPU's
//     sequential S grid axis, its causal block skip and its DMA elision by
//     the clamped index map: slots no row can see are never read, and a
//     row with kv_lens = 0 loads nothing. The last tile may be ragged
//     (S is a multiple of 8, not of 64): slots past the end read as zeros
//     and are masked.
//   * Loads. K and V tiles go from device memory straight into shared
//     memory in their own type with cp.async (16 bytes per copy, every copy
//     of a tile in flight at once; slots at or past the end are zero-filled
//     by the copy itself), double buffered: the next tile's copies run
//     behind this tile's math, so a block pays the memory latency about
//     once, not once per load.
//   * Per tile: each thread scores one key against its half of the rows;
//     one warp per row does the max / exp / sum of the online softmax
//     (masked probabilities are zeroed, never exp(NEG_INF - NEG_INF));
//     each thread then accumulates one output column for all rows.
//   * With bf16 inputs the probabilities are rounded to bf16 before the PV
//     product, as the TPU kernel does (p.astype(v.dtype)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBlockKV = 64;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive elements of shared memory as floats.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float out(float x) { return x; }
  static __device__ __forceinline__ float round_p(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 out(float x) { return __float2bfloat16(x); }
  static __device__ __forceinline__ float round_p(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// 16-byte asynchronous copy to shared memory; copies nothing and writes
// zeros when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ bool visible(int kv, int p, int kvl, int window) {
  return kv <= p && kv < kvl && (window <= 0 || p - kv < window);
}

// Shared memory layout, in bytes (every region a multiple of 16):
//   Ks [2][64][HD + 16/sizeof(T)] T   (row padded by 16 bytes)
//   Vs [2][64][HD] T
//   Qs [BR][HD + 4] f32
//   Ps [BR][64] f32, then M, L, alpha [BR] f32 and Pos [BR] i32.
template <typename T, int HD>
struct Layout {
  static constexpr int kRowK = HD + 16 / sizeof(T);  // K row stride, elements
  static constexpr int kRowQ = HD + 4;               // Q row stride, floats
  static constexpr size_t kStageK = sizeof(T) * kBlockKV * kRowK;
  static constexpr size_t kStageV = sizeof(T) * kBlockKV * HD;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = 2 * kStageK;
  static constexpr size_t q_off = v_off + 2 * kStageV;
  template <int BR>
  static constexpr size_t bytes() {
    return q_off + sizeof(float) * (BR * kRowQ + BR * kBlockKV + 4 * BR);
  }
};

// Issue the copies of KV tile [s0, s0 + 64) into one stage; slots at or
// past kv_end are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kb, const T* vb,
                                          int s0, int kv_end, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int ROWK = Layout<T, HD>::kRowK;
#pragma unroll
  for (int i = tid; i < kBlockKV * HD / VEC; i += kThreads) {
    const int e = i * VEC, jj = e / HD, h = e % HD;
    const bool ok = s0 + jj < kv_end;
    const long long off = ok ? (long long)(s0 + jj) * HD + h : 0;
    cp_async16(ks + jj * ROWK + h, kb + off, ok);
    cp_async16(vs + jj * HD + h, vb + off, ok);
  }
}

template <typename T, int HD, int BR>
__global__ void __launch_bounds__(kThreads)
flash_gqa_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kv_lens, T* __restrict__ out,
                 int t_len, int n_heads, int kv_heads, int s_len,
                 long long q_sb, long long q_st, long long q_sn,
                 long long o_sb, long long o_st, long long o_sn,
                 int window, float scale) {
  using L = Layout<T, HD>;
  constexpr int ROWK = L::kRowK;
  constexpr int ROWQ = L::kRowQ;
  constexpr int RG = kThreads / kBlockKV;        // row groups in the score phase
  constexpr int RPG = (BR + RG - 1) / RG;        // rows per group
  constexpr int CG = kThreads / HD;              // column groups in the PV phase

  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);   // 2 stages
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);   // 2 stages
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* Ps = Qs + BR * ROWQ;
  float* Ms = Ps + BR * kBlockKV;
  float* Ls = Ms + BR;
  float* As = Ls + BR;
  int* Pos = reinterpret_cast<int*>(As + BR);
  __shared__ int s_minpos, s_maxpos;

  const int g_size = n_heads / kv_heads;
  const int rows = g_size * t_len;
  const int b = blockIdx.x / kv_heads;
  const int kh = blockIdx.x % kv_heads;
  const int row0 = blockIdx.y * BR;
  const int tid = threadIdx.x;

  // Rows of this tile: r -> (g, t) = (row / T, row % T), query head kh*G + g.
  // Rows past the end get position -1, which sees nothing.
  for (int r = tid; r < BR; r += kThreads) {
    const int row = row0 + r;
    Pos[r] = row < rows ? qpos[(long long)b * t_len + row % t_len] : -1;
    Ms[r] = kNegInf;
    Ls[r] = 0.f;
  }
  for (int i = tid; i < BR * HD; i += kThreads) {
    const int r = i / HD, h = i % HD, row = row0 + r;
    float x = 0.f;
    if (row < rows) {
      const int g = row / t_len, t = row % t_len;
      x = to_f32(q[b * q_sb + t * q_st + (long long)(kh * g_size + g) * q_sn + h]);
    }
    Qs[r * ROWQ + h] = x;
  }
  __syncthreads();
  if (tid == 0) {
    int mn = 0x7fffffff, mx = -1;
    for (int r = 0; r < BR; ++r) {
      if (row0 + r < rows) {
        mn = min(mn, Pos[r]);
        mx = max(mx, Pos[r]);
      }
    }
    s_minpos = mn;
    s_maxpos = mx;
  }
  __syncthreads();

  const int kvl = min(max(kv_lens[b], 0), s_len);
  const int kv_end = min(kvl, s_maxpos + 1);  // exclusive; <= 0 means no tile
  int kv_begin = 0;
  if (window > 0 && kv_end > 0) kv_begin = max(0, s_minpos - window + 1);
  const long long head_off = ((long long)b * kv_heads + kh) * s_len * HD;
  const T* kb = k + head_off;
  const T* vb = v + head_off;

  const int j = tid % kBlockKV, rg = tid / kBlockKV;  // score phase
  const int col = tid % HD, cg = tid / HD;            // PV phase
  const int warp = tid / 32, lane = tid % 32;
  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.f;

  int s0 = kv_begin / kBlockKV * kBlockKV;
  if (s0 < kv_end) load_tile<T, HD>(Ks, Vs, kb, vb, s0, kv_end, tid);
  cp_async_commit();
  for (int stage = 0; s0 < kv_end; s0 += kBlockKV, stage ^= 1) {
    // 1. Start the next tile's copies into the other stage, then wait for
    // this tile's.
    if (s0 + kBlockKV < kv_end) {
      load_tile<T, HD>(Ks + (stage ^ 1) * kBlockKV * ROWK,
                       Vs + (stage ^ 1) * kBlockKV * HD, kb, vb,
                       s0 + kBlockKV, kv_end, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* kt = Ks + stage * kBlockKV * ROWK;
    const T* vt = Vs + stage * kBlockKV * HD;

    // 2. Scores: thread (j, rg) dots key j with rows rg, rg + RG, ...
    float sc[RPG];
#pragma unroll
    for (int i = 0; i < RPG; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int h = 0; h < HD; h += 4) {
      const float4 kk = ld4(kt + j * ROWK + h);
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        const int r = rg + RG * i;
        if (r < BR) {
          const float4 qq = ld4(Qs + r * ROWQ + h);
          sc[i] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int r = rg + RG * i;
      if (r < BR) {
        Ps[r * kBlockKV + j] =
            visible(s0 + j, Pos[r], kvl, window) ? sc[i] * scale : kNegInf;
      }
    }
    __syncthreads();

    // 3. Online softmax, one warp per row. Masked entries get p = 0: a row
    // masked so far keeps m = NEG_INF, and exp(NEG_INF - NEG_INF) = 1
    // would pollute l.
    for (int r = warp; r < BR; r += kWarps) {
      const int p = Pos[r];
      const float sa = Ps[r * kBlockKV + lane];
      const float sb = Ps[r * kBlockKV + lane + 32];
      float mx = fmaxf(sa, sb);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = visible(s0 + lane, p, kvl, window) ? expf(sa - m_new) : 0.f;
      const float pb = visible(s0 + lane + 32, p, kvl, window) ? expf(sb - m_new) : 0.f;
      float sum = pa + pb;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      Ps[r * kBlockKV + lane] = Cvt<T>::round_p(pa);
      Ps[r * kBlockKV + lane + 32] = Cvt<T>::round_p(pb);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        As[r] = alpha;
        Ls[r] = alpha * Ls[r] + sum;
        Ms[r] = m_new;
      }
    }
    __syncthreads();

    // 4. PV: thread (col, cg) owns output column col for every row, over the
    // key quads jj = 4*cg, 4*cg + 4*CG, ...
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[r] *= As[r];
    for (int jj = 4 * cg; jj < kBlockKV; jj += 4 * CG) {
      const float v0 = to_f32(vt[(jj + 0) * HD + col]);
      const float v1 = to_f32(vt[(jj + 1) * HD + col]);
      const float v2 = to_f32(vt[(jj + 2) * HD + col]);
      const float v3 = to_f32(vt[(jj + 3) * HD + col]);
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const float4 pp = ld4(Ps + r * kBlockKV + jj);
        acc[r] += pp.x * v0 + pp.y * v1 + pp.z * v2 + pp.w * v3;
      }
    }
    __syncthreads();  // this stage is free for the copies two tiles on
  }
  cp_async_wait<0>();
  __syncthreads();

  // Column groups (H = 64: two) hold partial sums over disjoint keys: add
  // them through shared memory (the K stages are free now).
  if (CG > 1) {
    float* part = reinterpret_cast<float*>(smem + L::k_off);
    if (cg > 0) {
#pragma unroll
      for (int r = 0; r < BR; ++r) part[((cg - 1) * BR + r) * HD + col] = acc[r];
    }
    __syncthreads();
    if (cg == 0) {
      for (int c = 1; c < CG; ++c) {
#pragma unroll
        for (int r = 0; r < BR; ++r) acc[r] += part[((c - 1) * BR + r) * HD + col];
      }
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const int row = row0 + r;
      if (row < rows) {
        const int g = row / t_len, t = row % t_len;
        const float l = Ls[r];
        out[b * o_sb + t * o_st + (long long)(kh * g_size + g) * o_sn + col] =
            Cvt<T>::out(acc[r] / (l == 0.f ? 1.f : l));
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *qpos, *kv_lens;
  void* out;
  int b, t, n, kh, s;
  long long q_sb, q_st, q_sn, o_sb, o_st, o_sn;
  int window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int BR>
int launch(const Args& a) {
  constexpr size_t smem = Layout<T, HD>::template bytes<BR>();
  auto kernel = flash_gqa_kernel<T, HD, BR>;
  // Above 48 KB a block's dynamic shared memory must be opted into, once.
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int rows = (a.n / a.kh) * a.t;
  dim3 grid(a.b * a.kh, (rows + BR - 1) / BR);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.qpos),
      static_cast<const int*>(a.kv_lens), static_cast<T*>(a.out), a.t, a.n,
      a.kh, a.s, a.q_sb, a.q_st, a.q_sn, a.o_sb, a.o_st, a.o_sn, a.window,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_br(const Args& a, int br) {
  switch (br) {
    case 1: return launch<T, HD, 1>(a);
    case 2: return launch<T, HD, 2>(a);
    case 4: return launch<T, HD, 4>(a);
    case 8: return launch<T, HD, 8>(a);
    case 16: return launch<T, HD, 16>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_hd(const Args& a, int h, int br) {
  switch (h) {
    case 64: return launch_br<T, 64>(a, br);
    case 128: return launch_br<T, 128>(a, br);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). Strides are in
// elements; the head dim of q and out is contiguous. `br` is the row tile:
// 16 for prefill, the next power of two >= G for decode.
extern "C" int flash_gqa_attention(
    const void* q, const void* k, const void* v, const void* q_positions,
    const void* kv_lens, void* out, int b, int t, int n, int kh, int s, int h,
    long long q_sb, long long q_st, long long q_sn, long long o_sb,
    long long o_st, long long o_sn, int window, float scale, int is_bf16,
    int br, void* stream) {
  Args a{q, k, v, q_positions, kv_lens, out, b, t, n, kh, s,
         q_sb, q_st, q_sn, o_sb, o_st, o_sn, window, scale,
         static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch_hd<__nv_bfloat16>(a, h, br) : launch_hd<float>(a, h, br);
}
