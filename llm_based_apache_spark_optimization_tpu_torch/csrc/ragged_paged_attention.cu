// Ragged paged attention over the shared KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ragged_paged_attention` of the JAX package
// (llm_based_apache_spark_optimization_tpu/ops/pallas/paged_attention.py):
// its body `_make_paged_decode_kernel(dequant=False)` driven by
// `_run_paged_grid`. Same contract:
//
//   q [B, T, N, H] (strided, head dim contiguous), k_pool and v_pool
//   [P, K, PS, H] contiguous (one layer of the pool), page_table [B, NP]
//   i32 (unmapped entries hold the sentinel P), q_positions [B, T] i32,
//   kv_lens [B] i32 (clipped to [0, NP * PS]), q_lens [B] i32 (clipped to
//   [0, T]) -> out [B, T, N, H]. Logical position s of row b lives at pool
//   page page_table[b, s / PS], offset s % PS. Window columns t >= q_lens[b]
//   come out as exact zeros; kv_lens = 0 parks a row (zeros, nothing read).
//
// What bounds it on an H100 SXM (3.35 TB/s): at decode the live K + V bytes,
// sum_b min(kv_lens[b], max position + 1) * K * H * 2 * itemsize, plus q and
// out, over 3.35 TB/s. The TPU kernel avoids a gathered copy of the rows by
// putting the table in the DMA engine's index map; here the kernels look up
// each slot's page themselves, so a row streams only its live pages,
// straight from the pool.
//
// Design. Both kernels find key slot s of (b, kv head kh) through the table
// at row (page * K + kh) * PS + s % PS (`kv_source::PagedSrc`); slots
// before the window, past the live length, or behind a sentinel or
// out-of-range entry are never read, so a sentinel page is never touched
// and NaN in dead offsets never reaches a sum. Page sizes: any multiple of
// 8.
//   * Decode (T == 1, `splits` >= 1): the split-KV kernel of
//     `decode_split.cuh`, shared with every other decode launch: each (row
//     b, KV head) row's live range is split over a cluster of `splits`
//     blocks (the wrapper's `decode_split_plan`), K/V read into registers,
//     a lane reading the table once per page it enters, the partial
//     softmaxes merged in the cluster.
//   * Query windows (T > 1), bf16 (`splits` >= 1): the kernel of
//     `window_split.cuh`, FlashAttention-2 on the tensor cores (mma.sync),
//     16 to 64 folded rows r = g * T + t a block (the JAX fold), each row
//     tile's live KV range split in whole 64-slot tiles over a cluster of
//     `splits` blocks (the wrapper's `window_split_plan`), the table read
//     once per page a tile spans, the partials merged in the cluster.
//   * Query windows (T > 1), f32 (`splits` = 0): the tile kernel of
//     `gqa_tile.cuh` (shared with the contiguous f32 prefill), one block per
//     (row b, KV head, tile of 16 folded rows), walking tiles of 64 slots
//     from the first slot its rows' window can see to min(kv_lens[b], the
//     tile's max live position + 1). f32 stays off the tensor cores: TF32
//     would miss the 1e-4 tolerance.

#include "decode_split.cuh"
#include "gqa_tile.cuh"
#include "kv_source.cuh"
#include "window_split.cuh"

// Returns the launch's error or cudaGetLastError() after it (0 = launched).
// Strides are in elements; the head dim of q and out is contiguous.
// `splits` (1..8) is the cluster size of the decode kernel (T == 1) or of
// a bf16 query window's kernel (T > 1); 0 for an f32 query window, which
// the tile kernel serves.
extern "C" int ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* q_positions, const void* kv_lens, const void* q_lens, void* out,
    int b, int t, int n, int kh, int num_pages, int page_size, int np_tab,
    int h, long long q_sb, long long q_st, long long q_sn, long long o_sb,
    long long o_st, long long o_sn, int window, float scale, int is_bf16,
    int splits, void* stream) {
  const kv_source::PagedSrc src{static_cast<const int*>(table), num_pages, kh, page_size,
                                np_tab};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((splits > 0) != (t == 1 || is_bf16)) return (int)cudaErrorInvalidValue;
  if (t == 1) {
    decode_split::Args a{q, k_pool, v_pool, nullptr, nullptr, q_positions, kv_lens, q_lens,
                         out, b, n, kh, q_sb, q_sn, o_sb, o_sn, window, scale, st};
    return decode_split::launch_any<false>(a, src, h, is_bf16, splits);
  }
  if (is_bf16) {
    window_split::Args a{q, k_pool, v_pool, nullptr, nullptr, q_positions, kv_lens, q_lens,
                         out, b, t, n, q_sb, q_st, q_sn, o_sb, o_st, o_sn, window, scale, st};
    return window_split::launch_any<false>(a, src, h, splits);
  }
  gqa_tile::Args a{q, k_pool, v_pool, nullptr, nullptr, q_positions, kv_lens, q_lens,
                   out, b, t, n, kh, q_sb, q_st, q_sn, o_sb, o_st, o_sn, window, scale, st};
  if (h == 64) return gqa_tile::launch<float, float, 64>(a, src);  // f32 window
  if (h == 128) return gqa_tile::launch<float, float, 128>(a, src);
  return (int)cudaErrorInvalidValue;
}
