// The paged query-window kernel: every bf16 launch of ragged paged
// attention with T > 1 (the ragged mixed round's first step, a ragged
// prefill chunk), over the bf16 or the int8 page pool, for Hopper (sm_90a).
//
// Replaces, at T > 1, the TPU kernels `_make_paged_decode_kernel(False)`
// and `_make_paged_decode_kernel(True)` with `_dequant_page_streams`
// (llm_based_apache_spark_optimization_tpu/ops/pallas/paged_attention.py:71,
// their pallas_call at :225; wrappers `ragged_paged_attention` :272 and
// `ragged_paged_attention_quantized` :304).
//
// Contract: `gqa_tile.cuh`'s, over the page pool, for bf16 q and out. Rows
// r = g * T + t fold the G query heads of a KV head; key slot s of (b, kv
// head kh) sits on page table[b, s / PS] at offset s % PS (an entry
// outside [0, P) is unmapped); the query at position p sees s <= p, s <
// kv_lens[b] and, with a window w > 0, p - s < w; window columns t >=
// q_lens[b] take position -1 and come out as exact zeros; kv_lens = 0
// parks a row (zeros, nothing read); f32 online softmax, probabilities
// rounded to bf16 before the PV product (the TPU kernel's
// p.astype(v.dtype)); a row with no visible key returns exact zeros. Slots
// no row of a block can see, and unmapped pages, are never read: the
// copies zero-fill them (values and scales), so NaN there cannot leak.
// Over the int8 pool a slot stands for bf16(float(k8) * ks), rounded once,
// as the TPU kernel's dequantize does. Head dims 64 and 128, pages of any
// multiple of 8 slots.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the
// larger of the bytes (q and out, and the live K/V a row's rows can see:
// min(kv_lens, max position + 1) slots, 2 * H * 2 bytes a slot and head in
// bf16, 2 * H + 8 over int8) over 3.35 TB/s and 4 * H FLOPs a visible (row,
// key) pair over 989 TFLOP/s. At the 7B mixed round (B = 8, T = 32, two
// rows of 4096 live slots) that is 156 MB in bf16 (0.047 ms) and 81 MB
// over int8 (0.024 ms): bytes.
//
// Design. The tile kernel that served these launches first (`gqa_tile.cuh`)
// walked each row's KV range in one block of 16 rows with scalar FMAs; at
// the mixed round two rows of 4096 slots made 64 sequential tiles a block
// the whole launch's time (0.67 ms at 7B). Here:
//   * Tensor cores. FlashAttention-2 on mma.sync.m16n8k16: each warp holds
//     16 folded rows, K by ldmatrix, V by ldmatrix.trans, the online softmax
//     in registers with quad shuffles: the warp step is
//     `flash_prefill::warp_tile_step`, the contiguous bf16 prefill's own.
//     Q's A fragments are read from shared memory at each tile (ldmatrix),
//     not held across the loop: held, they took the kernel to the
//     255-register cap with spills; read, it stays under 190 with none.
//   * Row tiles sized to the window: a block holds 16 * WARPS rows, WARPS =
//     min(4, ceil(G * T / 16)) (7B T = 32: 2 row groups; 3B T = 16, G = 3:
//     3), so no row group is empty; longer windows take several 64-row
//     tiles. Up to 32 rows, each row group has two warps that take half of
//     every tile's keys each (a block of 4 warps at 7B T = 32, not 2) and
//     merge their softmax states in shared memory at the end: a lone block's
//     time a tile is the step's latency, so more warps on the same tile
//     beat fewer. A tile's KV walk runs from the first slot its rows'
//     window can see to min(kv_lens, its largest live position + 1).
//   * Split-KV over a thread-block cluster, as `decode_split.cuh` does at T
//     == 1: grid (B * K * row tiles, splits), cluster (1, splits, 1),
//     splits <= 8 from the wrapper's pure `window_split_plan`. Each block
//     finds its tile's live range on the device and takes its rank's share
//     in whole 64-slot tiles; the partials (m, l, acc) of the ranks that had
//     work meet in rank 0's merge through distributed shared memory in rank
//     order, and rank 0 writes out (a range that fits one share is written
//     by its block directly). One launch, no host sync, capturable in a
//     CUDA graph, and bit-identical output from launch to launch (fixed
//     merge orders, no atomics). A row tile that sees nothing (parked,
//     dead columns) is known as such by every rank: rank 0 writes its
//     zeros and no block waits at a barrier; a rank with an empty share
//     waits at the two cluster barriers only. Both keep the cost of a
//     split low where most rows are short, which the plan cannot see.
//   * Longest rows first. Blocks reach the SMs roughly in index order, and
//     a mixed round's long rows (chunks and decode rows near the end of a
//     4096-slot row) sit anywhere in the batch: each block ranks the rows
//     by kv_lens (descending, ties by index) and the j-th group of blocks
//     takes the j-th longest row, so the long rows start in the first wave
//     and the short ones fill in behind them (7B T = 32 at 3 splits: 0.1115
//     ms before, 0.092 after, `chip_smoke.py`). Which block computes a row
//     does not change its bits.
//   * One page-table read per page a tile spans: warp 0 reads a tile's
//     entries one lane a page, a tile ahead (the load issued at the top of
//     an iteration, used at its end), and spreads each slot's row to shared
//     memory with shuffles; the copies then read rows, not the table.
//   * Loads: 16-byte cp.async with zero-fill, K/V tiles of 64 slots in rows
//     of H + 8 bf16 (ldmatrix reads no bank twice). bf16 pool: two stages,
//     the next tile's copies behind this tile's products. int8 pool: three
//     stages of int8 values and f32 scales (4-byte cp.async), so two tiles'
//     copies are in flight while one tile is dequantized (byte_perm
//     widening, one product, one rounding to bf16) into the bf16 tile the
//     products read. A lone block walking a long row is bound by its
//     step's latency, not by its copies: more warps on the row (key
//     halves, splits) shorten it, more stages would not.
//
// Registers a thread (ptxas -v for sm_90a; `chip_smoke.py`'s build phase
// prints them), no spills:
//   pool   H    WARPS = 1    2    3    4
//   bf16   128        167  166  182  189
//          64         128  128  148  158
//   int8   128        154  152  177  186
//          64         108  110  147  152

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "flash_prefill.cuh"
#include "hopper.cuh"
#include "kv_source.cuh"

namespace window_split {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using gqa_tile::kBlockKV;
using gqa_tile::kNegInf;

constexpr int kMaxSplits = 8;  // blocks of a portable cluster
constexpr unsigned kFull = 0xffffffffu;

// Warps a row group of 16 rows: two, each taking half of every tile's keys,
// while a block holds at most 32 rows; one above.
__host__ __device__ constexpr int key_warps(int row_groups) { return row_groups <= 2 ? 2 : 1; }

template <int HD, typename KV, int WARPS>
struct Layout {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kRow = HD + 8;           // bf16 row stride (16 bytes of padding)
  static constexpr int kRows = 16 * WARPS;      // folded query rows a block
  static constexpr int kKeyWarps = key_warps(WARPS);
  static constexpr int kThreads = 32 * WARPS * kKeyWarps;
  static constexpr int kStages = kQuant ? 3 : 2;  // tiles of copies in the ring
  static constexpr int kTiles = kQuant ? 1 : 2;   // bf16 K/V tiles the products read
  static constexpr size_t kTile = sizeof(bf16) * kBlockKV * kRow;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = kTiles * kTile;
  static constexpr size_t q_off = 2 * kTiles * kTile;
  static constexpr size_t rows_off = q_off + sizeof(bf16) * kRows * kRow;
  // int8 staging: values [kStages][64][HD] for K and V, scales [kStages][64].
  static constexpr size_t kStage8 = kQuant ? kBlockKV * HD : 0;
  static constexpr size_t kStageS = kQuant ? sizeof(float) * kBlockKV : 0;
  static constexpr size_t k8_off = rows_off + sizeof(long long) * kStages * kBlockKV;
  static constexpr size_t v8_off = k8_off + kStages * kStage8;
  static constexpr size_t ks_off = v8_off + kStages * kStage8;
  static constexpr size_t vs_off = ks_off + kStages * kStageS;
  static constexpr size_t bytes = vs_off + kStages * kStageS;
  // After the loop the split partials reuse the K/V tiles: acc [kRows][HD],
  // then m and l [kRows], f32; behind them the second key warps' states
  // (accumulators [WARPS][HD / 8][32 lanes] float4, then m, l [WARPS][32]
  // float4) for the merge inside the block.
  static constexpr size_t merge_off = sizeof(float) * kRows * (HD + 2);
  static constexpr size_t merge_bytes =
      kKeyWarps > 1 ? sizeof(float4) * WARPS * 32 * (HD / 8 + 1) : 0;
  static_assert(merge_off + merge_bytes <= q_off, "partials fit the tiles");
};

using kv_source::PagedSrc;

// Warp 0's lane `lane`: the first row of the lane-th page tile `s0` spans
// inside [lo, hi) (-1: unmapped, or no such page), one table read.
__device__ __forceinline__ long long page_base(const PagedSrc& pg, int b, int kh, int s0,
                                               int lo, int hi, int lane) {
  const int a = max(s0, lo), e = min(s0 + kBlockKV, hi);
  if (a >= e) return -1;
  const int pi = a / pg.page_size + lane;
  return pi > (e - 1) / pg.page_size ? -1 : pg.base(b, kh, pi);
}

// Warp 0: each slot of tile `s0` -> its row (-1 outside [lo, hi) or on an
// unmapped page), from the page bases of `page_base` held one a lane.
__device__ __forceinline__ void spread_rows(long long* rows, const PagedSrc& pg, int s0,
                                            int lo, int hi, long long base, int lane) {
  const int first = max(s0, lo) / pg.page_size;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int jj = lane + 32 * half, s = s0 + jj;
    const bool live = s >= lo && s < hi;
    const int pi = live ? s / pg.page_size : first;
    const long long bb = __shfl_sync(kFull, base, pi - first);
    rows[jj] = live && bb >= 0 ? bb + (s - pi * pg.page_size) : -1;
  }
}

// Issue the copies of one tile (rows resolved in `rows`) into ring stage
// `st`: bf16 K/V straight into the tiles the products read, or int8 values
// and scales into staging. Unresolved slots are zero-filled.
template <int HD, typename KV, int WARPS>
__device__ __forceinline__ void issue(char* smem, const long long* rows, int st,
                                      const KV* __restrict__ k, const KV* __restrict__ v,
                                      const float* __restrict__ kscale,
                                      const float* __restrict__ vscale, int tid) {
  using L = Layout<HD, KV, WARPS>;
  if constexpr (L::kQuant) {
    int8_t* k8 = reinterpret_cast<int8_t*>(smem + L::k8_off) + st * kBlockKV * HD;
    int8_t* v8 = reinterpret_cast<int8_t*>(smem + L::v8_off) + st * kBlockKV * HD;
    float* ks = reinterpret_cast<float*>(smem + L::ks_off) + st * kBlockKV;
    float* vs = reinterpret_cast<float*>(smem + L::vs_off) + st * kBlockKV;
    for (int i = tid; i < kBlockKV * HD / 16; i += L::kThreads) {
      const int jj = i / (HD / 16), h = (i % (HD / 16)) * 16;
      const long long row = rows[jj];
      const bool ok = row >= 0;
      const long long off = ok ? row * HD + h : 0;
      hopper::cp_async16(k8 + jj * HD + h, k + off, ok);
      hopper::cp_async16(v8 + jj * HD + h, v + off, ok);
      if (h == 0) {
        hopper::cp_async4(ks + jj, kscale + (ok ? row : 0), ok);
        hopper::cp_async4(vs + jj, vscale + (ok ? row : 0), ok);
      }
    }
  } else {
    bf16* kt = reinterpret_cast<bf16*>(smem + L::k_off) + st * kBlockKV * L::kRow;
    bf16* vt = reinterpret_cast<bf16*>(smem + L::v_off) + st * kBlockKV * L::kRow;
    for (int i = tid; i < kBlockKV * HD / 8; i += L::kThreads) {
      const int jj = i / (HD / 8), h = (i % (HD / 8)) * 8;
      const long long row = rows[jj];
      const bool ok = row >= 0;
      const long long off = ok ? row * HD + h : 0;
      hopper::cp_async16(kt + jj * L::kRow + h, k + off, ok);
      hopper::cp_async16(vt + jj * L::kRow + h, v + off, ok);
    }
  }
}

// 16 int8 values times their scale, each product rounded once to bf16 and
// packed in pairs: the int8 -> f32 widening on the full-rate pipes (a byte
// in offset binary placed as the low mantissa byte of 2^23, minus 2^23 +
// 128, gives float(x) exactly; `decode_split.cuh`'s dequant16).
__device__ __forceinline__ void dequant16(const uint4& raw, float sc, uint32_t* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + j)) - 8388736.f) * sc;
    out[2 * i] = hopper::pack_bf16(f[0], f[1]);
    out[2 * i + 1] = hopper::pack_bf16(f[2], f[3]);
  }
}

// Dequantize staging stage `st` into the bf16 K/V tiles.
template <int HD, int WARPS>
__device__ __forceinline__ void dequant_tile(char* smem, int st, int tid) {
  using L = Layout<HD, int8_t, WARPS>;
  const int8_t* k8 = reinterpret_cast<const int8_t*>(smem + L::k8_off) + st * kBlockKV * HD;
  const int8_t* v8 = reinterpret_cast<const int8_t*>(smem + L::v8_off) + st * kBlockKV * HD;
  const float* ks = reinterpret_cast<const float*>(smem + L::ks_off) + st * kBlockKV;
  const float* vs = reinterpret_cast<const float*>(smem + L::vs_off) + st * kBlockKV;
  bf16* kt = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* vt = reinterpret_cast<bf16*>(smem + L::v_off);
  for (int i = tid; i < kBlockKV * HD / 16; i += L::kThreads) {
    const int jj = i / (HD / 16), h = (i % (HD / 16)) * 16;
    uint32_t x[8];
    dequant16(*reinterpret_cast<const uint4*>(k8 + jj * HD + h), ks[jj], x);
    uint4* kd = reinterpret_cast<uint4*>(kt + jj * L::kRow + h);
    kd[0] = make_uint4(x[0], x[1], x[2], x[3]);
    kd[1] = make_uint4(x[4], x[5], x[6], x[7]);
    dequant16(*reinterpret_cast<const uint4*>(v8 + jj * HD + h), vs[jj], x);
    uint4* vd = reinterpret_cast<uint4*>(vt + jj * L::kRow + h);
    vd[0] = make_uint4(x[0], x[1], x[2], x[3]);
    vd[1] = make_uint4(x[4], x[5], x[6], x[7]);
  }
}

template <int HD, typename KV, int WARPS>
__global__ void __launch_bounds__(32 * WARPS * key_warps(WARPS))
window_split_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, const PagedSrc pg,
                    const int* __restrict__ qpos, const int* __restrict__ kv_lens,
                    const int* __restrict__ q_lens, bf16* __restrict__ out, int batch,
                    int t_len, int n_heads, long long q_sb, long long q_st, long long q_sn,
                    long long o_sb, long long o_st, long long o_sn, int window,
                    float scale_log2) {
  using L = Layout<HD, KV, WARPS>;
  constexpr int ROW = L::kRow;
  constexpr int BR = L::kRows;
  constexpr int NT = L::kThreads;
  constexpr int NS = L::kStages;
  constexpr int KS = HD / 16;
  constexpr int KW = L::kKeyWarps;
  constexpr int NKEYS = kBlockKV / KW;  // keys a warp takes of each tile
  constexpr int NW = WARPS * KW;

  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const bf16* Ks = reinterpret_cast<const bf16*>(smem + L::k_off);
  const bf16* Vs = reinterpret_cast<const bf16*>(smem + L::v_off);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  long long* Rows = reinterpret_cast<long long*>(smem + L::rows_off);  // [NS][64]
  __shared__ int s_min[NW], s_max[NW], s_row;

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int kv_heads = pg.kv_heads;
  const int g_size = n_heads / kv_heads;
  const int rows = g_size * t_len;
  const int row_tiles = (rows + BR - 1) / BR;
  const int kh = blockIdx.x / row_tiles % kv_heads;
  const int row0 = blockIdx.x % row_tiles * BR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Longest rows first: the blocks come to the SMs roughly in index order,
  // so the j-th group of blocks takes the row whose kv_lens ranks j-th
  // (descending, ties by index). Long rows then start in the first wave,
  // and the short ones fill in behind them. Which block computes a row
  // does not change its bits.
  for (int r = tid; r < batch; r += NT) {
    const int key = kv_lens[r];
    int j = 0;
    for (int x = 0; x < batch; ++x) {
      const int kx = kv_lens[x];
      j += kx > key || (kx == key && x < r);
    }
    if (j == (int)(blockIdx.x / (kv_heads * row_tiles))) s_row = r;
  }
  __syncthreads();
  const int b = s_row;
  const int rg = warp % WARPS, kw = warp / WARPS;  // row group, key half
  const int gid = lane / 4, tig = lane % 4;
  const int q_live = q_lens ? q_lens[b] : t_len;
  const int kv_len = kv_lens[b];

  // Position of block row r (-1: past the rows, or a dead window column).
  auto row_pos = [&](int r) {
    const int row = row0 + r, t = row % t_len;
    return (row < rows && t < q_live) ? qpos[(long long)b * t_len + t] : -1;
  };
  const int pos_a = row_pos(rg * 16 + gid);  // this lane's two rows
  const int pos_b = row_pos(rg * 16 + gid + 8);
  {
    int mn = INT_MAX, mx = -1;
    if (tid < BR) {
      const int p = row_pos(tid);
      if (p >= 0) mn = mx = p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(kFull, mn, o));
      mx = max(mx, __shfl_xor_sync(kFull, mx, o));
    }
    if (lane == 0) {
      s_min[warp] = mn;
      s_max[warp] = mx;
    }
  }
  __syncthreads();
  int minpos = INT_MAX, maxpos = -1;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    minpos = min(minpos, s_min[w]);
    maxpos = max(maxpos, s_max[w]);
  }

  // The tile's live range, and this rank's share of it in whole tiles; the
  // ranks whose share is not empty are the first `used`.
  const int kvl = min(max(kv_len, 0), pg.np_tab * pg.page_size);
  const int kv_end = min(kvl, maxpos + 1);  // exclusive
  const int kv_begin = window > 0 && kv_end > 0 ? max(0, minpos - window + 1) : 0;
  const int first = kv_begin / kBlockKV;
  const int n_all = kv_end > kv_begin ? (kv_end + kBlockKV - 1) / kBlockKV - first : 0;
  const int per = (n_all + splits - 1) / splits;
  const int used = n_all > 0 ? (n_all + per - 1) / per : 0;
  const int tb = first + min(n_all, rank * per);
  const int nt = first + min(n_all, (rank + 1) * per) - tb;
  auto tile_s0 = [&](int i) { return (tb + i) * kBlockKV; };
  auto out_row = [&](int row) {
    const int g = row / t_len, t = row % t_len;
    return out + b * o_sb + t * o_st + (long long)(kh * g_size + g) * o_sn;
  };
  if (n_all == 0) {
    // No row of the tile sees a key (parked, dead columns, an empty
    // window): every rank knows it, rank 0 writes the zeros, none waits.
    if (rank == 0) {
      for (int i = tid; i < BR * HD / 8; i += NT) {
        const int r = i / (HD / 8), h = (i % (HD / 8)) * 8, row = row0 + r;
        if (row < rows) *reinterpret_cast<uint4*>(out_row(row) + h) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }
  if (nt == 0) {  // an empty share of a split row: only the merge's two barriers
    cluster.sync();
    cluster.sync();
    return;
  }

  // Q rows into shared memory, 16 bytes a copy; rows past the end are zero.
  // Each step reads its A fragments from here (ldmatrix), which keeps 32
  // registers a thread free for the step's own accumulators.
  for (int i = tid; i < BR * HD / 8; i += NT) {
    const int r = i / (HD / 8), h = (i % (HD / 8)) * 8, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) {
      const int g = row / t_len, t = row % t_len;
      val = *reinterpret_cast<const uint4*>(
          q + b * q_sb + t * q_st + (long long)(kh * g_size + g) * q_sn + h);
    }
    *reinterpret_cast<uint4*>(Qs + r * ROW + h) = val;
  }
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  // Prologue: warp 0 resolves the first NS tiles' rows; the first NS - 1
  // tiles' copies go out.
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int s0 = tile_s0(i);
      const int hi = i < nt ? kv_end : kv_begin;  // a tile past the share: none
      const long long base = page_base(pg, b, kh, s0, kv_begin, hi, lane);
      spread_rows(Rows + i * kBlockKV, pg, s0, kv_begin, hi, base, lane);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nt) issue<HD, KV, WARPS>(smem, Rows + i * kBlockKV, i, k, v, kscale, vscale, tid);
    hopper::cp_async_commit();
  }

  for (int i = 0; i < nt; ++i) {
    const int st = i % NS;
    // 1. Tile i + NS - 1's copies go out (its rows resolved a tile ago);
    // warp 0 issues the table reads of tile i + NS, used at the end.
    const int nx = i + NS - 1;
    if (nx < nt)
      issue<HD, KV, WARPS>(smem, Rows + (nx % NS) * kBlockKV, nx % NS, k, v, kscale, vscale,
                           tid);
    hopper::cp_async_commit();
    long long base = -1;
    const int ahead = i + NS, ahead_s0 = tile_s0(ahead);
    const int ahead_hi = ahead < nt ? kv_end : kv_begin;
    if (warp == 0) base = page_base(pg, b, kh, ahead_s0, kv_begin, ahead_hi, lane);
    // 2. Tile i has landed.
    hopper::cp_async_wait<NS - 1>();
    __syncthreads();
    if constexpr (L::kQuant) {
      dequant_tile<HD, WARPS>(smem, st, tid);
      // Tile i + NS's rows go where tile i's were (read when it was issued).
      if (warp == 0)
        spread_rows(Rows + st * kBlockKV, pg, ahead_s0, kv_begin, ahead_hi, base, lane);
      __syncthreads();
    }
    // 3. This warp's 16 rows against its keys of the tile.
    uint32_t qf[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      hopper::ldsm_x4(qf[kk], Qs + (rg * 16 + (lane & 15)) * ROW + kk * 16 + (lane >> 4) * 8);
    const int t = (L::kQuant ? 0 : st) * kBlockKV + kw * NKEYS;  // this warp's first key row
    flash_prefill::warp_tile_step<HD, NKEYS>(qf, Ks + t * ROW, Vs + t * ROW,
                                             tile_s0(i) + kw * NKEYS, pos_a, pos_b, kvl,
                                             window, scale_log2, m_a, m_b, l_a, l_b, o, lane);
    if constexpr (!L::kQuant) {
      if (warp == 0)
        spread_rows(Rows + st * kBlockKV, pg, ahead_s0, kv_begin, ahead_hi, base, lane);
      __syncthreads();  // this stage is free for the copies two tiles on
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the tiles

  // The key halves of a row group meet in its first warp, lane by lane (the
  // same fragment layout), through shared memory behind the partials.
  if constexpr (KW > 1) {
    float4* macc = reinterpret_cast<float4*>(smem + L::merge_off);
    float4* mml = macc + WARPS * (HD / 8) * 32;
    if (kw == 1) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        macc[(rg * (HD / 8) + n) * 32 + lane] = make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
      mml[rg * 32 + lane] = make_float4(m_a, m_b, l_a, l_b);
    }
    __syncthreads();
    if (kw == 0) {
      const float4 ml = mml[rg * 32 + lane];
      const float mn_a = fmaxf(m_a, ml.x), mn_b = fmaxf(m_b, ml.y);
      const float a0 = exp2f(m_a - mn_a), a1 = exp2f(ml.x - mn_a);
      const float b0 = exp2f(m_b - mn_b), b1 = exp2f(ml.y - mn_b);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float4 x = macc[(rg * (HD / 8) + n) * 32 + lane];
        o[n][0] = o[n][0] * a0 + x.x * a1;
        o[n][1] = o[n][1] * a0 + x.y * a1;
        o[n][2] = o[n][2] * b0 + x.z * b1;
        o[n][3] = o[n][3] * b0 + x.w * b1;
      }
      l_a = l_a * a0 + ml.z * a1;
      l_b = l_b * b0 + ml.w * b1;
      m_a = mn_a;
      m_b = mn_b;
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, off);
    l_b += __shfl_xor_sync(kFull, l_b, off);
  }
  if (used == 1) {
    // One block sees the whole range (a cluster of one, or a short row):
    // its rows straight out of the accumulators; the empty ranks, if any,
    // wait at the two barriers below.
    if (kw == 0) {
      const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
      const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + rg * 16 + gid + 8 * half;
        if (row >= rows) continue;
        bf16* dst = out_row(row) + 2 * tig;
        const float inv = half ? inv_b : inv_a;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          *reinterpret_cast<uint32_t*>(dst + 8 * n) =
              hopper::pack_bf16(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
        }
      }
    }
    if (splits > 1) {
      cluster.sync();
      cluster.sync();
    }
    return;
  }

  // The block's partial: acc [BR][HD], m and l [BR], over the K/V tiles.
  float* acc = reinterpret_cast<float*>(smem);
  float* pm = acc + BR * HD;
  float* pl = pm + BR;
  if (kw == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rg * 16 + gid + 8 * half;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<float2*>(acc + r * HD + 8 * n + 2 * tig) =
            make_float2(o[n][2 * half], o[n][2 * half + 1]);
      }
      if (tig == 0) {
        pm[r] = half ? m_b : m_a;
        pl[r] = half ? l_b : l_a;
      }
    }
  }
  cluster.sync();  // every block's partial is written and visible to the cluster

  // Rank 0 merges the `used` partials in rank order, four columns a step,
  // every rank's loaded before any is used.
  if (rank == 0) {
    for (int e = tid; e < BR * HD / 4; e += NT) {
      const int r = e / (HD / 4), c = (e % (HD / 4)) * 4, row = row0 + r;
      if (row >= rows) continue;
      float bm[kMaxSplits], bl[kMaxSplits];
      float4 ba[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        bm[s] = kNegInf;
        bl[s] = 0.f;
        ba[s] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s < used) {
          const float* racc = cluster.map_shared_rank(acc, s);
          bm[s] = racc[BR * HD + r];
          bl[s] = racc[BR * HD + BR + r];
          ba[s] = *reinterpret_cast<const float4*>(racc + r * HD + c);
        }
      }
      float mx = kNegInf;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) mx = fmaxf(mx, bm[s]);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float ll = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < used) {
          const float wt = exp2f(bm[s] - mx);
          a.x += wt * ba[s].x;
          a.y += wt * ba[s].y;
          a.z += wt * ba[s].z;
          a.w += wt * ba[s].w;
          ll += wt * bl[s];
        }
      }
      const float inv = 1.f / (ll == 0.f ? 1.f : ll);
      *reinterpret_cast<uint2*>(out_row(row) + c) =
          make_uint2(hopper::pack_bf16(a.x * inv, a.y * inv), hopper::pack_bf16(a.z * inv, a.w * inv));
    }
  }
  cluster.sync();  // keep every block's shared memory alive until rank 0 has read it
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *qpos, *kv_lens, *q_lens;
  void* out;
  int b, t, n;
  long long q_sb, q_st, q_sn, o_sb, o_st, o_sn;
  int window;
  float scale;
  cudaStream_t stream;
};

template <int HD, typename KV, int WARPS>
int launch(const Args& a, const PagedSrc& pg, int splits) {
  constexpr int smem = (int)Layout<HD, KV, WARPS>::bytes;
  auto kernel = window_split_kernel<HD, KV, WARPS>;
  static bool opted_in = false;  // above 48 KB, opt in once
  if (!opted_in) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int rows = (a.n / pg.kv_heads) * a.t;
  const int row_tiles = (rows + 16 * WARPS - 1) / (16 * WARPS);
  const dim3 grid(a.b * pg.kv_heads * row_tiles, splits);
  return hopper::launch_cluster(
      kernel, grid, Layout<HD, KV, WARPS>::kThreads, smem, splits, a.stream,
      static_cast<const bf16*>(a.q),
      static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale), pg,
      static_cast<const int*>(a.qpos), static_cast<const int*>(a.kv_lens),
      static_cast<const int*>(a.q_lens), static_cast<bf16*>(a.out), a.b, a.t, a.n, a.q_sb,
      a.q_st, a.q_sn, a.o_sb, a.o_st, a.o_sn, a.window, a.scale * 1.4426950408889634f);
}

template <int HD, typename KV>
int launch_rows(const Args& a, const PagedSrc& pg, int splits) {
  const int warps = min(4, ((a.n / pg.kv_heads) * a.t + 15) / 16);
  if (warps == 1) return launch<HD, KV, 1>(a, pg, splits);
  if (warps == 2) return launch<HD, KV, 2>(a, pg, splits);
  if (warps == 3) return launch<HD, KV, 3>(a, pg, splits);
  return launch<HD, KV, 4>(a, pg, splits);
}

// A bf16 query window (T > 1) over the paged pool, the cache bf16 or
// (`Quant`) int8 with per-slot scales (a.k_scale, a.v_scale); `splits`
// (1..8) is the cluster's size. Returns the launch's error or
// cudaGetLastError() after it (0 = launched).
template <bool Quant>
int launch_any(const Args& a, const PagedSrc& pg, int h, int splits) {
  using KV = typename std::conditional<Quant, int8_t, bf16>::type;
  if ((h != 64 && h != 128) || splits < 1 || splits > kMaxSplits || a.t < 2 ||
      pg.kv_heads < 1 || a.n % pg.kv_heads || pg.page_size % 8)
    return (int)cudaErrorInvalidValue;
  return h == 64 ? launch_rows<64, KV>(a, pg, splits) : launch_rows<128, KV>(a, pg, splits);
}

}  // namespace window_split
