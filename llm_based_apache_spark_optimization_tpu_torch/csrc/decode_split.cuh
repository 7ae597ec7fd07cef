// The split-KV decode attention kernel: every T == 1 attention launch of
// the port, over a contiguous cache (flash_gqa_attention.cu,
// flash_gqa_attention_quantized.cu) or the paged pool
// (ragged_paged_attention.cu, ragged_paged_attention_quantized.cu), with the
// cache stored in the compute type or in int8, for Hopper (sm_90a).
//
// Replaces, at T == 1, the TPU kernels `_make_decode_kernel(False)` and
// `_make_decode_kernel(True)`
// (llm_based_apache_spark_optimization_tpu/ops/pallas/attention.py:184, its
// pallas_call at :313) and `_make_paged_decode_kernel(False)` and
// `_make_paged_decode_kernel(True)` (paged_attention.py:71, its pallas_call
// at :225), the int8 ones with their dequantize (`_dequant_streams`,
// `_dequant_page_streams`).
//
// Contract, per batch row b (T == 1):
//   q [B, 1, N, H] (strided, head dim contiguous), q_positions [B] i32,
//   kv_lens [B] i32, optional q_lens [B] i32 -> out [B, 1, N, H]. Slot s of
//   (b, kv head kh) sits at row `Src::row_at(b, kh, s, cache)` of the K and
//   V arrays (H values a row), or nowhere (-1: an unmapped page, never
//   read); `Src::len()` is the virtual length S the kv_lens clip to
//   (`kv_source.cuh`). The cache holds the compute type T (KV = T), or int8
//   (KV = int8_t) with one f32 scale a row for K and for V, the slot then
//   standing for T(float(k8) * ks), rounded once to the compute type, as
//   the TPU kernels' dequantize does. The query at position p sees slots
//   [max(0, p - w + 1) (w > 0 a window), min(kv_lens[b], p + 1)); a row with
//   q_lens[b] = 0 sees none. Scale H**-0.5, f32 online softmax, the
//   probabilities rounded to T before the PV product (p.astype(v.dtype)),
//   exact zeros for a row with no visible key. Slots no row can see are
//   never read: NaN in a dead slot, a dead scale or an unmapped page cannot
//   leak. Element types bf16 or f32; head dims 64 and 128; G = N / K up to
//   16.
//
// What bounds it on an H100 SXM: the live cache bytes, sum_b live_b * K *
// 2 * H * sizeof(KV) (plus 8 bytes of scales a slot over int8), plus q and
// out, over 3.35 TB/s. At the 7B engine's decode (one row at 375 slots)
// that is 6.1 MB in bf16 (1.8 us) and 3.2 MB in int8 (1 us); at the
// scheduler's eight slots (64-1024 live) 72 MB in bf16 (21 us) and 37 MB in
// int8 (11 us).
//
// Design. The tile kernel (`gqa_tile.cuh`) that first served these launches
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
//     the launch within the blocks the card holds at once.
//   * Four to five block-wide barriers and a shared-memory round trip of
//     each 64-slot tile, three of four warps idle in the softmax at G = 1.
//     Here there is no barrier in the slot loop. Each warp owns a contiguous
//     run of its block's slots, a lane group per slot, each lane holding
//     `Slot<KV>::kCols` columns of K and of V: 16 int8 columns in one 16-byte
//     load (8 lanes a slot at H = 128, 4 at H = 64), 16 bf16 columns in two,
//     8 f32 columns in two (16 lanes at H = 128, 8 at H = 64), the loads of
//     two steps in flight in registers. A lane widens its values to f32 in
//     registers (int8 off the quarter-rate conversion pipe, `dequant16`;
//     bf16 by a shift or a mask, as a bf16 is the top half of its f32), dots
//     them against its columns of the query rows, adds the group's partial
//     dots with shuffles, and keeps its own online softmax (m, l, and the
//     p.v accumulators of its columns) in registers, rescaling them only
//     when its running max moves.
//   * A page-table lookup per 16-byte copy. Here a lane remembers the page of
//     its last slot (`RowCache`): the table is read once per page a lane
//     group enters, the lanes of a group reading the same word.
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
// G query heads of its KV head in registers (kCols columns a row a lane,
// beside kCols accumulators a row); G > 4 runs ceil(G / R) row chunks as
// blocks of their own, which read the same K/V again, mostly from L2. Of the
// options for G > 4 (q in shared memory, mma.sync m16n8k16 on widened
// fragments) this is the one that keeps the G <= 4 path of every model the
// repo serves (7B G = 1, 3B G = 3, 1B G = 4) free of shared-memory reads in
// the loop, at the price of the K/V reads' repeats at G = 8 and 16, which
// no served configuration has.
//
// Registers a thread (ptxas -v for sm_90a, CUDA 12.8; `chip_smoke.py`'s
// build phase prints them) of the 48 instantiations; none spills.
//   cache (compute type)  source  H    R = 1  R = 2  R = 4
//   bf16 (bf16)           contig  128  120    148    220
//                                 64   120    147    229
//                         paged   128  118    154    225
//                                 64   118    154    227
//   f32 (f32)             contig  128  104    120    139
//                                 64   104    120    141
//                         paged   128   96    120    153
//                                 64    96    120    152
//   int8 (bf16)           contig  128  120    128    210
//                                 64   120    128    209
//                         paged   128   96    128    213
//                                 64    96    128    215
//   int8 (f32)            contig  128  124    128    210
//                                 64   122    128    209
//                         paged   128   96    128    212
//                                 64    96    128    215
// At R = 1 (7B, G = 1) four blocks of 128 threads fit an SM's registers,
// at R = 2 three, at R = 4 (3B, 1B) two.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "kv_source.cuh"

namespace decode_split {

namespace cg = cooperative_groups;
using kv_source::RowCache;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 16;       // a split's share is a multiple of this many slots
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

// One lane's share of one slot: kCols values of K and of V in kVecs 16-byte
// words each (at most 32 bytes: int8 16 columns in one word, bf16 16 in
// two, f32 8 in two), and over int8 the slot's two scales; zeros (and so
// zero values, never NaN) when not read.
template <typename KV>
struct Slot {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kCols = sizeof(KV) == 4 ? 8 : 16;
  static constexpr int kVecs = kCols * (int)sizeof(KV) / 16;
  uint4 k[kVecs], v[kVecs];
  float ks, vs;
};

template <int HD, typename KV, typename Src>
__device__ __forceinline__ Slot<KV> load_slot(const KV* __restrict__ k,
                                              const KV* __restrict__ v,
                                              const float* __restrict__ kscale,
                                              const float* __restrict__ vscale,
                                              const Src& src, int b, int kh, int s,
                                              bool live, int col0, RowCache& rc) {
  Slot<KV> r;
#pragma unroll
  for (int i = 0; i < Slot<KV>::kVecs; ++i) r.k[i] = r.v[i] = make_uint4(0, 0, 0, 0);
  r.ks = r.vs = 0.f;
  if (live) {
    const long long row = src.row_at(b, kh, s, rc);
    if (row >= 0) {
      const uint4* kp = reinterpret_cast<const uint4*>(k + row * HD + col0);
      const uint4* vp = reinterpret_cast<const uint4*>(v + row * HD + col0);
#pragma unroll
      for (int i = 0; i < Slot<KV>::kVecs; ++i) {
        r.k[i] = __ldg(kp + i);
        r.v[i] = __ldg(vp + i);
      }
      if constexpr (Slot<KV>::kQuant) {
        r.ks = __ldg(kscale + row);
        r.vs = __ldg(vscale + row);
      }
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
  for (int i = 0; i < 16; i += 2) Cvt<T>::round2(x[i], x[i + 1]);
}

// A lane's kCols values of K or V as f32: int8 dequantized (`dequant16`);
// bf16 widened exactly, a shift for the low half of a word and a mask for
// the high half (a bf16 is the top half of its f32); f32 as it is.
template <typename T, typename KV>
__device__ __forceinline__ void widen(const uint4* w, float sc, float* x) {
  if constexpr (Slot<KV>::kQuant) {
    dequant16<T>(w[0], sc, x);
  } else {
#pragma unroll
    for (int i = 0; i < Slot<KV>::kVecs; ++i) {
      const uint32_t u[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (sizeof(KV) == 2) {
          x[8 * i + 2 * j] = __uint_as_float(u[j] << 16);
          x[8 * i + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
        } else {
          x[4 * i + j] = __uint_as_float(u[j]);
        }
      }
    }
  }
}

template <typename T, typename KV, int HD, int R, typename Src>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, const Src src,
                    const int* __restrict__ qpos, const int* __restrict__ kv_lens,
                    const int* __restrict__ q_lens, T* __restrict__ out, int n_heads,
                    int kv_heads, long long q_sb, long long q_sn, long long o_sb,
                    long long o_sn, int window, float scale) {
  static_assert(Slot<KV>::kQuant || std::is_same<KV, T>::value,
                "the cache is int8 or the compute type");
  constexpr int kCols = Slot<KV>::kCols;
  constexpr int LPS = HD / kCols;        // lanes a slot
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

  // This lane's columns of the block's R query rows (pad rows are 0).
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
  Slot<KV> buf[kDepth];
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
        widen<T, KV>(buf[d].k, buf[d].ks, x);
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
        widen<T, KV>(buf[d].v, buf[d].vs, x);
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

template <typename T, typename KV, int HD, int R, typename Src>
int launch(const Args& a, const Src& src, int splits) {
  const int chunks = (a.n / a.kh + R - 1) / R;
  const dim3 grid(a.b * a.kh * chunks, splits);
  return hopper::launch_cluster(
      decode_split_kernel<T, KV, HD, R, Src>, grid, kThreads, 0, splits, a.stream,
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), src, static_cast<const int*>(a.qpos),
      static_cast<const int*>(a.kv_lens), static_cast<const int*>(a.q_lens),
      static_cast<T*>(a.out), a.n, a.kh, a.q_sb, a.q_sn, a.o_sb, a.o_sn, a.window, a.scale);
}

template <typename T, typename KV, int HD, typename Src>
int launch_rows(const Args& a, const Src& src, int splits) {
  const int g = a.n / a.kh;
  if (g <= 1) return launch<T, KV, HD, 1>(a, src, splits);
  if (g == 2) return launch<T, KV, HD, 2>(a, src, splits);
  return launch<T, KV, HD, 4>(a, src, splits);
}

// Dispatch on element type and head dim; `Quant` reads an int8 cache with
// per-slot scales (a.k_scale, a.v_scale), else a cache of the compute type.
// `splits` (1..8) is the cluster's size. Returns the launch's error or
// cudaGetLastError() after it (0 = launched).
template <bool Quant, typename Src>
int launch_any(const Args& a, const Src& src, int h, int is_bf16, int splits) {
  using B = __nv_bfloat16;
  using KB = typename std::conditional<Quant, int8_t, B>::type;
  using KF = typename std::conditional<Quant, int8_t, float>::type;
  if ((h != 64 && h != 128) || splits < 1 || splits > kMaxSplits || a.kh < 1 ||
      a.n % a.kh)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    return h == 64 ? launch_rows<B, KB, 64>(a, src, splits)
                   : launch_rows<B, KB, 128>(a, src, splits);
  }
  return h == 64 ? launch_rows<float, KF, 64>(a, src, splits)
                 : launch_rows<float, KF, 128>(a, src, splits);
}

}  // namespace decode_split
