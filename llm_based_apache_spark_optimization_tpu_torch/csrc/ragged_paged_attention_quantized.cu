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
// Design: ragged_paged_attention.cu's two kernels over the int8 source.
// Decode (T == 1, `splits` >= 1): the split-KV kernel of `decode_split.cuh`,
// the int8 values dequantized in registers. Query windows (T > 1, `splits`
// = 0): the tile kernel of `gqa_tile.cuh`, 16 folded rows a block; each
// slot's H int8 values come in 16-byte cp.async copies and its scale in a
// 4-byte one, into double-buffered staging, and one pass per tile
// dequantizes into the compute-type tile. Both find key slot s of (b, kv
// head kh) through the table (`kv_source::PagedSrc`) at row
// (page * K + kh) * PS + s % PS of the values and of the scales. Slots
// before the window, past the live length, or behind a sentinel entry read
// as zeros (values and scale) and are never loaded, so NaN in a dead scale
// never reaches a sum.

#include "decode_split.cuh"
#include "gqa_tile.cuh"
#include "kv_source.cuh"

// Returns the launch's error or cudaGetLastError() after it (0 = launched).
// Strides are in elements; the head dim of q and out is contiguous.
// `splits` (1..8, T == 1 only) is the decode kernel's cluster size; 0 for a
// query window (T > 1), which the tile kernel serves.
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
  if ((splits > 0) != (t == 1)) return (int)cudaErrorInvalidValue;
  if (splits > 0) {
    decode_split::Args a{q, k_pool, v_pool, k_scale, v_scale, q_positions, kv_lens,
                         q_lens, out, b, n, kh, q_sb, q_sn, o_sb, o_sn, window, scale, st};
    return decode_split::launch_any<true>(a, src, h, is_bf16, splits);
  }
  gqa_tile::Args a{q, k_pool, v_pool, k_scale, v_scale, q_positions, kv_lens, q_lens,
                   out, b, t, n, kh, q_sb, q_st, q_sn, o_sb, o_st, o_sn, window, scale, st};
  return gqa_tile::launch_any<true>(a, src, h, is_bf16);
}
