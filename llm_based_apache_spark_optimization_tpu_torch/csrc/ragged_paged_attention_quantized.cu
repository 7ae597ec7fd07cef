// Ragged paged attention over the int8 KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel `ragged_paged_attention_quantized` of the JAX
// package (llm_based_apache_spark_optimization_tpu/ops/pallas/
// paged_attention.py): its body `_make_paged_decode_kernel(dequant=True)`
// with `_dequant_page_streams`, driven by `_run_paged_grid`. Same contract:
//
//   q [B, T, N, H] (strided, head dim contiguous), k_pool and v_pool
//   [P, K, PS, H] int8 contiguous (one layer of the pool), k_scale and
//   v_scale [P, K, PS] f32 (one scale per position), page_table [B, NP] i32
//   (unmapped entries hold the sentinel P), q_positions [B, T] i32, kv_lens
//   [B] i32 (clipped to [0, NP * PS]), q_lens [B] i32 (clipped to [0, T])
//   -> out [B, T, N, H]. Logical position s of row b lives at pool page
//   page_table[b, s / PS], offset s % PS, and stands for
//   T(float(k8) * ks): dequantized to the compute type in the tile, as the
//   TPU kernel does. Window columns t >= q_lens[b] come out as exact zeros;
//   kv_lens = 0 parks a row (zeros, nothing read).
//
// What bounds it on an H100 SXM (3.35 TB/s): at decode the live pool bytes,
// sum_b min(kv_lens[b], max position + 1) * K * (2 * H + 8), plus q and out,
// over 3.35 TB/s: about half the bf16 pool's bytes.
//
// Design: ragged_paged_attention.cu's three kernels over the int8 source.
// Decode (T == 1, `splits` >= 1): the split-KV kernel of `decode_split.cuh`,
// the int8 values dequantized in registers. bf16 query windows (T > 1,
// `splits` >= 1): the kernel of `window_split.cuh`, whose int8 values (16-byte
// cp.async) and scales (4-byte) land in three stages of staging, two tiles'
// copies in flight while one tile is dequantized into the bf16 tile its
// tensor-core products read, the KV range split over a cluster. f32 query
// windows (T > 1, `splits` = 0): the tile kernel of `gqa_tile.cuh`, 16
// folded rows a block, int8 values and scales into double-buffered staging
// and one dequantize pass per tile. All find key slot s of (b, kv head kh)
// through the table at row (page * K + kh) * PS + s % PS of the values and
// of the scales. Slots before the window, past the live length, or behind a
// sentinel entry read as zeros (values and scale) and are never loaded, so
// NaN in a dead scale never reaches a sum.

#include "decode_split.cuh"
#include "gqa_tile.cuh"
#include "kv_source.cuh"
#include "window_split.cuh"

// Returns the launch's error or cudaGetLastError() after it (0 = launched).
// Strides are in elements; the head dim of q and out is contiguous.
// `splits` (1..8) is the cluster size of the decode kernel (T == 1) or of
// a bf16 query window's kernel (T > 1); 0 for an f32 query window, which
// the tile kernel serves.
extern "C" int ragged_paged_attention_quantized(
    const void* q, const void* k_pool, const void* k_scale, const void* v_pool,
    const void* v_scale, const void* table, const void* q_positions,
    const void* kv_lens, const void* q_lens, void* out, int b, int t, int n, int kh,
    int num_pages, int page_size, int np_tab, int h, long long q_sb, long long q_st,
    long long q_sn, long long o_sb, long long o_st, long long o_sn, int window,
    float scale, int is_bf16, int splits, void* stream) {
  const kv_source::PagedSrc src{static_cast<const int*>(table), num_pages, kh, page_size,
                                np_tab};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((splits > 0) != (t == 1 || is_bf16)) return (int)cudaErrorInvalidValue;
  if (t == 1) {
    decode_split::Args a{q, k_pool, v_pool, k_scale, v_scale, q_positions, kv_lens,
                         q_lens, out, b, n, kh, q_sb, q_sn, o_sb, o_sn, window, scale, st};
    return decode_split::launch_any<true>(a, src, h, is_bf16, splits);
  }
  if (is_bf16) {
    window_split::Args a{q, k_pool, v_pool, k_scale, v_scale, q_positions, kv_lens, q_lens,
                         out, b, t, n, q_sb, q_st, q_sn, o_sb, o_st, o_sn, window, scale, st};
    return window_split::launch_any<true>(a, src, h, splits);
  }
  gqa_tile::Args a{q, k_pool, v_pool, k_scale, v_scale, q_positions, kv_lens, q_lens,
                   out, b, t, n, kh, q_sb, q_st, q_sn, o_sb, o_st, o_sn, window, scale, st};
  if (h == 64) return gqa_tile::launch<float, int8_t, 64>(a, src);  // f32 window
  if (h == 128) return gqa_tile::launch<float, int8_t, 128>(a, src);
  return (int)cudaErrorInvalidValue;
}
