// The split-KV decode attention kernel over an int8 KV cache, shared by the
// contiguous cache (flash_gqa_attention_quantized.cu) and the paged pool
// (ragged_paged_attention_quantized.cu), for Hopper (sm_90a).
//
// Replaces, at T == 1, the TPU kernels `_make_decode_kernel(True)`
// (llm_based_apache_spark_optimization_tpu/ops/pallas/attention.py:184, its
// pallas_call at :313) and `_make_paged_decode_kernel(True)`
// (paged_attention.py:71, its pallas_call at :225), with their dequantize
// (`_dequant_streams`, `_dequant_page_streams`).
//
// Contract, per batch row b (T == 1):
//   q [B, 1, N, H] (strided, head dim contiguous), q_positions [B] i32,
//   kv_lens [B] i32, optional q_lens [B] i32 -> out [B, 1, N, H]. Slot s of
//   (b, kv head kh) sits at row `Src::row_at(b, kh, s, cache)` of the int8
//   K and V arrays (H values a row) and of the f32 scales (one a row), or
//   nowhere (-1: an unmapped page, read as zeros); `Src::len()` is the
//   virtual length S the kv_lens clip to. The slot stands for
//   T(float(k8) * ks), rounded once to the compute type, as the TPU
//   kernels' dequantize does. The query at position p sees slots
//   [max(0, p - w + 1) (w > 0 a window), min(kv_lens[b], p + 1)); a row with
//   q_lens[b] = 0 sees none. Scale H**-0.5, f32 online softmax, the
//   probabilities rounded to T before the PV product (p.astype(v.dtype)),
//   exact zeros for a row with no visible key. Slots no row can see are
//   never read: NaN in a dead scale or an unmapped page cannot leak.
//   Element types bf16 or f32; head dims 64 and 128; G = N / K up to 16.
//
// What bounds it on an H100 SXM: the live cache bytes,
// sum_b live_b * K * (2 * H + 8) (int8 K and V plus two f32 scales a
// slot), plus q and out, over 3.35 TB/s. At the 7B engine's decode that is
// 3.2 MB (about 1 us); at the scheduler's eight slots 37 MB (11 us).
//
// Design. The tile kernel (`gqa_tile.cuh`) that served these launches
// carried the online softmax down each row's cache inside one block, as the
// TPU kernel carries it down its sequential grid axis. It lost time three
// ways, and the design answers each:
//   * Too few blocks walking tiles in sequence (32 blocks on 132 SMs at the
//     7B engine, the longest paged row 16 tiles deep). Here each (b, kv
//     head) row's live range is split over a thread-block cluster of
//     `splits` <= 8 blocks: grid (B * K * row chunks, splits), cluster (1,
//     splits, 1). Every block finds its row's live range on the device
//     (kv_lens, position, window) and takes its rank's share, a whole number
//     of 16-slot runs, so the balance is per row with no host sync and the
//     launch stays capturable in a CUDA graph: no block walks more than
//     ceil(live / splits) slots rounded up to 16. Each block pays a fixed
//     chain (the row's lengths, the page table, the first slots, two
//     cluster barriers), so the wrapper's rule (`decode_split_plan`) keeps
//     the launch near one wave: 8 splits at the 7B engine's B = 1, 2 at
//     the scheduler's 8 slots.
//   * Four to five block-wide barriers and a shared-memory round trip of
//     the dequantized tile per 64 slots, three of four warps idle in the
//     softmax at G = 1. Here there is no barrier in the slot loop. Each warp
//     owns a contiguous run of its block's slots, a lane group per slot (8
//     lanes at H = 128, 4 at H = 64; 16 columns a lane, one 16-byte load of
//     K and of V), with the loads of two steps in flight in registers. A
//     lane dequantizes its 16 values in registers (off the quarter-rate
//     conversion pipe, `dequant16`), dots them against its columns of the
//     query rows, adds the group's partial dots with shuffles, and keeps its
//     own online softmax (m, l, and the p.v accumulators of its columns) in
//     registers, rescaling them only when its running max moves.
//   * A page-table lookup per 16-byte copy (8 per slot at H = 128). Here a
//     lane remembers the page of its last slot (`RowCache`): the table is
//     read once per page a lane group enters, the eight lanes of a group
//     reading the same word.
// The partial softmaxes merge in three fixed orders, so one input gives
// bit-identical output from launch to launch: the lane groups of a warp
// through xor shuffles, the warps of a block through shared memory in warp
// order, and the blocks of a cluster through distributed shared memory in
// rank order; rank 0 writes `out`. An empty range (a split past a short
// row, a window that hides it, kv_lens = 0) keeps m = -1e30 and l = 0, so
// its weight in the merge is exp(-1e30 - M) = 0, or 1 against a merged l
// of 0, and a row that sees nothing comes out as 0 / 1 = exact zeros.
//
// The query rows. A block holds R = min(4, next power of two >= G) of the
// G query heads of its KV head in registers (16 columns a row a lane, beside
// 16 accumulators a row); G > 4 runs ceil(G / R) row chunks as blocks of
// their own, which read the same K/V again, mostly from L2. Of the options
// for G > 4 (q in shared memory, mma.sync m16n8k16 on dequantized
// fragments) this is the one that keeps the G <= 4 path of every model the
// repo serves (7B G = 1, 3B G = 3, 1B G = 4) free of shared-memory reads in
// the loop, at the price of the K/V reads' repeats at G = 8 and 16, which
// no served configuration has.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace decode_q8 {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 16;       // a split's share is a multiple of this many slots
constexpr int kCols = 16;      // head-dim columns a lane: one 16-byte int8 load
constexpr int kMaxSplits = 8;  // blocks of a portable cluster
constexpr int kDepth = 2;      // warp steps whose loads are in flight at once
constexpr float kNegInf = -1e30f;

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float f32(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void round2(float&, float&) {}
  static __device__ __forceinline__ float out(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float f32(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  // Two values rounded to bf16 (nearest even) by one packed conversion.
  static __device__ __forceinline__ void round2(float& a, float& b) {
    const float2 r = __bfloat1622float2(__floats2bfloat162_rn(a, b));
    a = r.x;
    b = r.y;
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float x) { return __float2bfloat16(x); }
};

// The row of the page a lane read last: key = the slot's page index (or any
// value a contiguous source ignores), base = its first row, -1 if unmapped.
struct RowCache {
  int key;
  long long base;
};

// One lane's share of one slot: 16 int8 values of K and of V, and the
// slot's two scales; zeros (and so zero values, never NaN) when not read.
struct Raw {
  uint4 k, v;
  float ks, vs;
};

template <int HD, typename Src>
__device__ __forceinline__ Raw load_slot(const int8_t* __restrict__ k,
                                         const int8_t* __restrict__ v,
                                         const float* __restrict__ kscale,
                                         const float* __restrict__ vscale, const Src& src,
                                         int b, int kh, int s, bool live, int col0,
                                         RowCache& rc) {
  Raw r{make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0), 0.f, 0.f};
  if (live) {
    const long long row = src.row_at(b, kh, s, rc);
    if (row >= 0) {
      r.k = __ldg(reinterpret_cast<const uint4*>(k + row * HD + col0));
      r.v = __ldg(reinterpret_cast<const uint4*>(v + row * HD + col0));
      r.ks = __ldg(kscale + row);
      r.vs = __ldg(vscale + row);
    }
  }
  return r;
}

// 16 int8 values times their scale, each product rounded once to T. The
// int8 -> f32 conversion runs on the full-rate pipes, not the quarter-rate
// I2F: a byte of the value in offset binary (x + 128, one xor for four)
// becomes the low mantissa byte of 2^23, and subtracting 2^23 + 128 leaves
// float(x) exactly; the product with the scale is then the reference's.
template <typename T>
__device__ __forceinline__ void dequant16(const uint4& raw, float sc, float* x) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float f = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + j)) - 8388736.f;
      x[4 * i + j] = f * sc;
    }
  }
#pragma unroll
  for (int i = 0; i < kCols; i += 2) Cvt<T>::round2(x[i], x[i + 1]);
}

template <typename T, int HD, int R, typename Src>
__global__ void __launch_bounds__(kThreads)
decode_q8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                 const int8_t* __restrict__ v, const float* __restrict__ kscale,
                 const float* __restrict__ vscale, const Src src,
                 const int* __restrict__ qpos, const int* __restrict__ kv_lens,
                 const int* __restrict__ q_lens, T* __restrict__ out, int n_heads,
                 int kv_heads, long long q_sb, long long q_sn, long long o_sb,
                 long long o_sn, int window, float scale) {
  constexpr int LPS = HD / kCols;        // lanes a slot: 8 at H = 128, 4 at H = 64
  constexpr int SPW = 32 / LPS;          // slots a warp step
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ float part_acc[kWarps][R][HD];
  __shared__ float part_m[kWarps][R], part_l[kWarps][R];
  __shared__ float blk_acc[R][HD];
  __shared__ float blk_m[R], blk_l[R];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int g_size = n_heads / kv_heads;
  const int chunks = (g_size + R - 1) / R;
  const int bk = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int b = bk / kv_heads, kh = bk % kv_heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPS, col0 = (lane % LPS) * kCols;

  // The row's live range, this block's share of it, and this warp's run
  // (the three loads issued together: one memory round trip, not two).
  const int q_live = q_lens == nullptr ? 1 : q_lens[b];
  const int q_at = qpos[b];
  const int kv_len = kv_lens[b];
  const int p = q_live > 0 ? q_at : -1;
  const int kvl = min(max(kv_len, 0), src.len());
  const int kv_end = min(kvl, p + 1);
  const int kv_begin = window > 0 ? max(0, p - window + 1) : 0;
  const int live = max(0, kv_end - kv_begin);
  const int per = ((live + splits - 1) / splits + kRun - 1) / kRun * kRun;
  const int lo = kv_begin + min(live, rank * per);
  const int blen = kv_begin + min(live, (rank + 1) * per) - lo;
  const int wper = ((blen + kWarps - 1) / kWarps + SPW - 1) / SPW * SPW;
  const int wlo = lo + min(blen, warp * wper);
  const int whi = lo + min(blen, (warp + 1) * wper);
  const int steps = (whi - wlo + SPW - 1) / SPW;

  // This lane's 16 columns of the block's R query rows (pad rows are 0).
  float qr[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = chunk * R + r;
    const T* qrow = q + b * q_sb + (long long)(kh * g_size + g) * q_sn + col0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) qr[r][c] = g < g_size ? Cvt<T>::f32(qrow[c]) : 0.f;
  }

  float m[R], l[R], acc[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  RowCache rc{-1, -1};
  Raw buf[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const int s = wlo + d * SPW + grp;
    buf[d] = load_slot<HD>(k, v, kscale, vscale, src, b, kh, s, s < whi, col0, rc);
  }
  for (int st = 0; st < steps; st += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int i = st + d;
      if (i < steps) {  // warp-uniform: the shuffles below see every lane
        const bool valid = wlo + i * SPW + grp < whi;
        float x[kCols];
        dequant16<T>(buf[d].k, buf[d].ks, x);
        float sc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < kCols; ++c) dot = fmaf(qr[r][c], x[c], dot);
#pragma unroll
          for (int o = LPS / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kFull, dot, o);
          sc[r] = dot * scale;
        }
        dequant16<T>(buf[d].v, buf[d].vs, x);
        // Refill this buffer with the slot kDepth steps on.
        const int sn = wlo + (i + kDepth) * SPW + grp;
        buf[d] = load_slot<HD>(k, v, kscale, vscale, src, b, kh, sn, sn < whi, col0, rc);
        if (valid) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            // Rescale only when the running max moves (rarely, after the
            // first slots): alpha would be exactly 1 otherwise.
            if (sc[r] > m[r]) {
              const float alpha = expf(m[r] - sc[r]);
              l[r] *= alpha;
#pragma unroll
              for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
              m[r] = sc[r];
            }
            const float pe = expf(sc[r] - m[r]);
            const float pr = Cvt<T>::round(pe);
            l[r] += pe;
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pr, x[c], acc[r][c]);
          }
        }
      }
    }
  }

  // 1. The lane groups of the warp (same columns, disjoint slots).
#pragma unroll
  for (int o = LPS; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(kFull, m[r], o);
      const float lp = __shfl_xor_sync(kFull, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float a = expf(m[r] - mn), ao = expf(mo - mn);
      l[r] = a * l[r] + ao * lp;
      m[r] = mn;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float other = __shfl_xor_sync(kFull, acc[r][c], o);
        acc[r][c] = a * acc[r][c] + ao * other;
      }
    }
  }
  if (lane < LPS) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) part_acc[warp][r][col0 + c] = acc[r][c];
      if (lane == 0) {
        part_m[warp][r] = m[r];
        part_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  // 2. The warps of the block, in warp order.
  for (int e = tid; e < R * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    float mx = part_m[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, part_m[w][r]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(part_m[w][r] - mx);
      a += wt * part_acc[w][r][c];
      ll += wt * part_l[w][r];
    }
    blk_acc[r][c] = a;
    if (c == 0) {
      blk_m[r] = mx;
      blk_l[r] = ll;
    }
  }
  cluster.sync();  // every block's partial is written and visible to the cluster

  // 3. The blocks of the cluster, in rank order; rank 0 writes the rows.
  // Every rank's partial is loaded before any is used, so the reads of
  // distributed shared memory are in flight together.
  if (rank == 0) {
    for (int e = tid; e < R * HD; e += kThreads) {
      const int r = e / HD, c = e % HD, g = chunk * R + r;
      if (g >= g_size) continue;
      float bm[kMaxSplits], bl[kMaxSplits], ba[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        bm[s] = kNegInf;
        bl[s] = ba[s] = 0.f;
        if (s < splits) {
          bm[s] = cluster.map_shared_rank(&blk_m[0], s)[r];
          bl[s] = cluster.map_shared_rank(&blk_l[0], s)[r];
          ba[s] = cluster.map_shared_rank(&blk_acc[0][0], s)[r * HD + c];
        }
      }
      float mx = kNegInf;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) mx = fmaxf(mx, bm[s]);
      float a = 0.f, ll = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < splits) {
          const float wt = expf(bm[s] - mx);
          a += wt * ba[s];
          ll += wt * bl[s];
        }
      }
      out[b * o_sb + (long long)(kh * g_size + g) * o_sn + c] =
          Cvt<T>::out(a / (ll == 0.f ? 1.f : ll));
    }
  }
  cluster.sync();  // keep every block's shared memory alive until rank 0 has read it
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *qpos, *kv_lens, *q_lens;
  void* out;
  int b, n, kh;
  long long q_sb, q_sn, o_sb, o_sn;
  int window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int R, typename Src>
int launch(const Args& a, const Src& src, int splits) {
  const int chunks = (a.n / a.kh + R - 1) / R;
  const dim3 grid(a.b * a.kh * chunks, splits);
  return hopper::launch_cluster(
      decode_q8_kernel<T, HD, R, Src>, grid, kThreads, 0, splits, a.stream,
      static_cast<const T*>(a.q), static_cast<const int8_t*>(a.k),
      static_cast<const int8_t*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), src, static_cast<const int*>(a.qpos),
      static_cast<const int*>(a.kv_lens), static_cast<const int*>(a.q_lens),
      static_cast<T*>(a.out), a.n, a.kh, a.q_sb, a.q_sn, a.o_sb, a.o_sn, a.window, a.scale);
}

template <typename T, int HD, typename Src>
int launch_rows(const Args& a, const Src& src, int splits) {
  const int g = a.n / a.kh;
  if (g <= 1) return launch<T, HD, 1>(a, src, splits);
  if (g == 2) return launch<T, HD, 2>(a, src, splits);
  return launch<T, HD, 4>(a, src, splits);
}

// Dispatch on element type and head dim. `splits` (1..8) is the cluster's
// size. Returns the launch's error or cudaGetLastError() after it (0 =
// launched).
template <typename Src>
int launch_any(const Args& a, const Src& src, int h, int is_bf16, int splits) {
  using B = __nv_bfloat16;
  if ((h != 64 && h != 128) || splits < 1 || splits > kMaxSplits || a.kh < 1 ||
      a.n % a.kh)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    return h == 64 ? launch_rows<B, 64>(a, src, splits) : launch_rows<B, 128>(a, src, splits);
  }
  return h == 64 ? launch_rows<float, 64>(a, src, splits)
                 : launch_rows<float, 128>(a, src, splits);
}

}  // namespace decode_q8
