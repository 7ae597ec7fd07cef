// The flash GQA tile kernel shared by the contiguous-cache and the paged
// attention kernels, over a compute-type or an int8 cache, for Hopper
// (sm_90a): the f32 prefill of flash_gqa_attention.cu and the f32 query
// windows (T > 1) of ragged_paged_attention.cu and
// ragged_paged_attention_quantized.cu. Every decode launch (T == 1) runs the
// split kernel of decode_split.cuh; the bf16 prefill runs flash_prefill.cuh,
// which reuses `load_tile` and `visible`, and the bf16 query windows
// window_split.cuh.
//
// Contract, per batch row b:
//   q [B, T, N, H] (strided, head dim contiguous), q_positions [B, T] i32,
//   kv_lens [B] i32, optional q_lens [B] i32 (clipped to [0, T]) -> out
//   [B, T, N, H]. K/V rows are found through a source policy `Src`:
//   `Src::row(b, kh, s)` is the index of key slot s's [H] row of KV head kh
//   in the K and V arrays, or -1 when the slot has no backing row (an
//   unmapped page). `Src::len()` is the virtual length S the kv_lens clip to.
//   Key slot s is visible to the query at position p iff s <= p,
//   s < kv_lens[b] and, with a window w > 0, p - s < w. Scale H**-0.5.
//   Window columns t >= q_lens[b] take position -1: they see nothing and
//   come out as exact zeros. f32 online softmax; a row with no visible key
//   returns exact zeros. Slots no row can see (before the window, past the
//   live length, unmapped) are never read: zeros stand in, so garbage or
//   NaN there cannot leak through 0 * NaN.
//
// Element types: f32 in and out (T = float). Head dims 64 and 128. The
// cache is in that type (KV = T), or int8 (KV = int8_t) with one f32 scale
// per slot for K and for V, indexed by the same row as the slot's values:
// slot s of (b, kh) stands for T(float(k8[row, h]) * ks[row]), the TPU
// kernels' dequantize (`_dequant_streams`, `_dequant_page_streams`).
// `Layout` and `load_tile` also serve flash_prefill.cuh's bf16 tiles.
//
// Design (a first, simple kernel: scalar FMA in f32, no tensor cores, no
// TMA, no wgmma):
//   * Row fold. The G query heads of one KV head become rows r = g*T + t,
//     read from q through its strides (no transposed copy). One K/V tile in
//     shared memory serves all G heads, so K/V are read once per KV head,
//     never once per query head.
//   * Grid. One block per (b, kv head, tile of kRows = 16 rows).
//   * KV loop. A block walks KV tiles of 64 slots from the first slot its
//     rows' window can see (0 without a window) to min(kv_lens[b],
//     max position in the tile + 1): slots no row can see are never read,
//     and a row with kv_lens = 0 (or with every column dead) loads nothing.
//   * Loads. K and V rows go from device memory straight into shared memory
//     in their own type with cp.async (16 bytes per copy, every copy of a
//     tile in flight at once; slots without a row are zero-filled by the
//     copy itself), double buffered: the next tile's copies run behind this
//     tile's math.
//   * Per tile: each thread scores one key against its half of the rows;
//     one warp per row does the max / exp / sum of the online softmax
//     (masked probabilities are zeroed, never exp(NEG_INF - NEG_INF));
//     each thread then accumulates one output column for all rows.
//   * int8 cache: the copies bring each slot's H int8 values (16-byte
//     cp.async) and its 4-byte f32 scale (4-byte cp.async) into double-
//     buffered staging, half the bytes of a bf16 tile; once a tile has
//     landed, one pass dequantizes it into a single compute-type tile, which
//     the score and PV phases read as before. A slot that is not loaded
//     gets zero values and a zero scale, so it dequantizes to 0, never NaN.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace gqa_tile {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBlockKV = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;  // folded query rows a block (BR)

__device__ __forceinline__ float to_f32(float x) { return x; }

// Four consecutive elements of shared memory as floats.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The kernel's compute type is f32 (the bf16 launches run
// flash_prefill.cuh and window_split.cuh): outputs and probabilities as
// they are.
template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float out(float x) { return x; }
  static __device__ __forceinline__ float round_p(float x) { return x; }
};

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

__device__ __forceinline__ bool visible(int kv, int p, int kvl, int window) {
  return kv <= p && kv < kvl && (window <= 0 || p - kv < window);
}

// Shared memory layout, in bytes (every region a multiple of 16):
//   Ks [S][64][HD + 16/sizeof(T)] T   (row padded by 16 bytes)
//   Vs [S][64][HD] T                  (S = 2 stages; 1 over an int8 cache)
//   int8 cache only: K8, V8 [2][64][HD] int8, KSc, VSc [2][64] f32 staging
//   Qs [BR][HD + 4] f32                (BR = kRows)
//   Ps [BR][64] f32, then M, L, alpha [BR] f32 and Pos [BR] i32.
template <typename T, typename KV, int HD>
struct Layout {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kStagesT = kQuant ? 1 : 2;    // compute-type tiles
  static constexpr int kRowK = HD + 16 / sizeof(T);  // K row stride, elements
  static constexpr int kRowQ = HD + 4;               // Q row stride, floats
  static constexpr size_t kStageK = sizeof(T) * kBlockKV * kRowK;
  static constexpr size_t kStageV = sizeof(T) * kBlockKV * HD;
  static constexpr size_t kStage8 = kQuant ? kBlockKV * HD : 0;
  static constexpr size_t kStageS = kQuant ? sizeof(float) * kBlockKV : 0;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = kStagesT * kStageK;
  static constexpr size_t k8_off = v_off + kStagesT * kStageV;
  static constexpr size_t v8_off = k8_off + 2 * kStage8;
  static constexpr size_t ks_off = v8_off + 2 * kStage8;
  static constexpr size_t vs_off = ks_off + 2 * kStageS;
  static constexpr size_t q_off = vs_off + 2 * kStageS;
  static constexpr size_t kBytes =
      q_off + sizeof(float) * (kRows * kRowQ + kRows * kBlockKV + 4 * kRows);
};

// Issue the copies of KV tile [s0, s0 + 64) into one stage; slots outside
// [kv_begin, kv_end) or without a backing row are zero-filled. K rows are
// kRowK elements apart in shared memory, V rows ROWV.
template <typename T, int HD, typename Src, int ROWV = HD>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* k, const T* v,
                                          const Src& src, int b, int kh, int s0,
                                          int kv_begin, int kv_end, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int ROWK = Layout<T, T, HD>::kRowK;
#pragma unroll
  for (int i = tid; i < kBlockKV * HD / VEC; i += kThreads) {
    const int e = i * VEC, jj = e / HD, h = e % HD;
    const int s = s0 + jj;
    const long long row = (s >= kv_begin && s < kv_end) ? src.row(b, kh, s) : -1;
    const bool ok = row >= 0;
    const long long off = ok ? row * HD + h : 0;
    cp_async16(ks + jj * ROWK + h, k + off, ok);
    cp_async16(vs + jj * ROWV + h, v + off, ok);
  }
}

// The int8 twin: values into K8/V8 staging, each slot's scale into KSc/VSc.
template <int HD, typename Src>
__device__ __forceinline__ void load_tile_q8(int8_t* k8s, int8_t* v8s, float* kss,
                                             float* vss, const int8_t* k, const int8_t* v,
                                             const float* kscale, const float* vscale,
                                             const Src& src, int b, int kh, int s0,
                                             int kv_begin, int kv_end, int tid) {
  constexpr int VEC = 16;
#pragma unroll
  for (int i = tid; i < kBlockKV * HD / VEC; i += kThreads) {
    const int e = i * VEC, jj = e / HD, h = e % HD;
    const int s = s0 + jj;
    const long long row = (s >= kv_begin && s < kv_end) ? src.row(b, kh, s) : -1;
    const bool ok = row >= 0;
    const long long off = ok ? row * HD + h : 0;
    cp_async16(k8s + jj * HD + h, k + off, ok);
    cp_async16(v8s + jj * HD + h, v + off, ok);
    if (h == 0) {
      cp_async4(kss + jj, kscale + (ok ? row : 0), ok);
      cp_async4(vss + jj, vscale + (ok ? row : 0), ok);
    }
  }
}

// Dequantize one landed int8 stage into the compute-type tiles, four values
// a step: T(float(q) * scale), rounded once, as the TPU kernels do.
template <typename T, int HD>
__device__ __forceinline__ void dequant_tile(T* kt, T* vt, const int8_t* k8s,
                                             const int8_t* v8s, const float* kss,
                                             const float* vss, int tid) {
  constexpr int ROWK = Layout<T, int8_t, HD>::kRowK;
  for (int i = tid; i < kBlockKV * HD / 4; i += kThreads) {
    const int e = i * 4, jj = e / HD, h = e % HD;
    const char4 kq = *reinterpret_cast<const char4*>(k8s + e);
    const char4 vq = *reinterpret_cast<const char4*>(v8s + e);
    const float ksc = kss[jj], vsc = vss[jj];
    T* kd = kt + jj * ROWK + h;
    T* vd = vt + jj * HD + h;
    kd[0] = Cvt<T>::out((float)kq.x * ksc);
    kd[1] = Cvt<T>::out((float)kq.y * ksc);
    kd[2] = Cvt<T>::out((float)kq.z * ksc);
    kd[3] = Cvt<T>::out((float)kq.w * ksc);
    vd[0] = Cvt<T>::out((float)vq.x * vsc);
    vd[1] = Cvt<T>::out((float)vq.y * vsc);
    vd[2] = Cvt<T>::out((float)vq.z * vsc);
    vd[3] = Cvt<T>::out((float)vq.w * vsc);
  }
}

// Issue the copies of the tile at s0 into `stage`: compute-type K/V, or int8
// values and scales into the staging buffers.
template <typename T, typename KV, int HD, typename Src>
__device__ __forceinline__ void issue_tile(T* Ks, T* Vs, int8_t* K8, int8_t* V8,
                                           float* KSc, float* VSc, const KV* k,
                                           const KV* v, const float* kscale,
                                           const float* vscale, const Src& src, int b,
                                           int kh, int stage, int s0, int kv_begin,
                                           int kv_end, int tid) {
  if constexpr (Layout<T, KV, HD>::kQuant) {
    load_tile_q8<HD>(K8 + stage * kBlockKV * HD, V8 + stage * kBlockKV * HD,
                     KSc + stage * kBlockKV, VSc + stage * kBlockKV, k, v, kscale, vscale,
                     src, b, kh, s0, kv_begin, kv_end, tid);
  } else {
    constexpr int ROWK = Layout<T, KV, HD>::kRowK;
    load_tile<T, HD>(Ks + stage * kBlockKV * ROWK, Vs + stage * kBlockKV * HD, k, v, src,
                     b, kh, s0, kv_begin, kv_end, tid);
  }
}

template <typename T, typename KV, int HD, typename Src>
__global__ void __launch_bounds__(kThreads)
gqa_tile_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                const KV* __restrict__ v, const float* __restrict__ kscale,
                const float* __restrict__ vscale, const Src src,
                const int* __restrict__ qpos, const int* __restrict__ kv_lens,
                const int* __restrict__ q_lens, T* __restrict__ out,
                int t_len, int n_heads, int kv_heads,
                long long q_sb, long long q_st, long long q_sn,
                long long o_sb, long long o_st, long long o_sn,
                int window, float scale) {
  using L = Layout<T, KV, HD>;
  constexpr int BR = kRows;
  constexpr int ROWK = L::kRowK;
  constexpr int ROWQ = L::kRowQ;
  constexpr int RG = kThreads / kBlockKV;        // row groups in the score phase
  constexpr int RPG = (BR + RG - 1) / RG;        // rows per group
  constexpr int CG = kThreads / HD;              // column groups in the PV phase

  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);   // kStagesT stages
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  int8_t* K8 = reinterpret_cast<int8_t*>(smem + L::k8_off);  // int8 staging
  int8_t* V8 = reinterpret_cast<int8_t*>(smem + L::v8_off);
  float* KSc = reinterpret_cast<float*>(smem + L::ks_off);
  float* VSc = reinterpret_cast<float*>(smem + L::vs_off);
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
  const int q_live = q_lens ? q_lens[b] : t_len;

  // Rows of this tile: r -> (g, t) = (row / T, row % T), query head kh*G + g.
  // Rows past the end and dead window columns get position -1.
  for (int r = tid; r < BR; r += kThreads) {
    const int row = row0 + r;
    const int t = row % t_len;
    Pos[r] = (row < rows && t < q_live) ? qpos[(long long)b * t_len + t] : -1;
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
      if (Pos[r] >= 0) {
        mn = min(mn, Pos[r]);
        mx = max(mx, Pos[r]);
      }
    }
    s_minpos = mn;
    s_maxpos = mx;
  }
  __syncthreads();

  const int kvl = min(max(kv_lens[b], 0), src.len());
  const int kv_end = min(kvl, s_maxpos + 1);  // exclusive; <= 0 means no tile
  int kv_begin = 0;
  if (window > 0 && kv_end > 0) kv_begin = max(0, s_minpos - window + 1);

  const int j = tid % kBlockKV, rg = tid / kBlockKV;  // score phase
  const int col = tid % HD, cg = tid / HD;            // PV phase
  const int warp = tid / 32, lane = tid % 32;
  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.f;

  int s0 = kv_begin / kBlockKV * kBlockKV;
  if (s0 < kv_end) {
    issue_tile<T, KV, HD>(Ks, Vs, K8, V8, KSc, VSc, k, v, kscale, vscale, src, b, kh, 0,
                          s0, kv_begin, kv_end, tid);
  }
  cp_async_commit();
  for (int stage = 0; s0 < kv_end; s0 += kBlockKV, stage ^= 1) {
    // 1. Start the next tile's copies into the other stage, then wait for
    // this tile's (and, over an int8 cache, dequantize it).
    if (s0 + kBlockKV < kv_end) {
      issue_tile<T, KV, HD>(Ks, Vs, K8, V8, KSc, VSc, k, v, kscale, vscale, src, b, kh,
                            stage ^ 1, s0 + kBlockKV, kv_begin, kv_end, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int tstage = L::kQuant ? 0 : stage;
    if constexpr (L::kQuant) {
      dequant_tile<T, HD>(Ks, Vs, K8 + stage * kBlockKV * HD, V8 + stage * kBlockKV * HD,
                          KSc + stage * kBlockKV, VSc + stage * kBlockKV, tid);
      __syncthreads();
    }
    const T* kt = Ks + tstage * kBlockKV * ROWK;
    const T* vt = Vs + tstage * kBlockKV * HD;

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
  const void *q, *k, *v, *k_scale, *v_scale, *qpos, *kv_lens, *q_lens;
  void* out;
  int b, t, n, kh;
  long long q_sb, q_st, q_sn, o_sb, o_st, o_sn;
  int window;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int HD, typename Src>
int launch(const Args& a, const Src& src) {
  constexpr size_t smem = Layout<T, KV, HD>::kBytes;
  auto kernel = gqa_tile_kernel<T, KV, HD, Src>;
  // Above 48 KB a block's dynamic shared memory must be opted into, once.
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int rows = (a.n / a.kh) * a.t;
  dim3 grid(a.b * a.kh, (rows + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), src, static_cast<const int*>(a.qpos),
      static_cast<const int*>(a.kv_lens), static_cast<const int*>(a.q_lens),
      static_cast<T*>(a.out), a.t, a.n, a.kh, a.q_sb, a.q_st, a.q_sn,
      a.o_sb, a.o_st, a.o_sn, a.window, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace gqa_tile
