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
// Design: the tile kernel of `gqa_tile.cuh` over an int8 source, with key
// slot s of (b, kv head kh) found through the table at row
// (page * K + kh) * PS + s % PS of the values and of the scales (a page's
// PS scales are contiguous per (page, head)). Each slot's H int8 values
// come in 16-byte cp.async copies and its scale in a 4-byte one, into
// double-buffered staging; one pass per tile dequantizes into the compute-
// type tile. Slots before the window, past the live length, or behind a
// sentinel entry are zero-filled (values and scale) and never read, so NaN
// in a dead scale never reaches a sum. Grid and row tiles as in
// ragged_paged_attention.cu: one block per (row b, KV head, tile of BR
// folded rows r = g * T + t); decode uses BR = the next power of two >= G
// (up to 16), query windows BR = 16.

#include "gqa_tile.cuh"

namespace {

struct PagedSrc {
  const int* table;  // [B, NP]
  int num_pages, kv_heads, page_size, np_tab;
  __device__ __forceinline__ long long row(int b, int kh, int s) const {
    const int page = table[(long long)b * np_tab + s / page_size];
    if (page < 0 || page >= num_pages) return -1;
    return ((long long)page * kv_heads + kh) * page_size + s % page_size;
  }
  __device__ __forceinline__ int len() const { return np_tab * page_size; }
};

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). Strides are in
// elements; the head dim of q and out is contiguous.
extern "C" int ragged_paged_attention_quantized(
    const void* q, const void* k_pool, const void* k_scale, const void* v_pool,
    const void* v_scale, const void* table, const void* q_positions,
    const void* kv_lens, const void* q_lens, void* out, int b, int t, int n, int kh,
    int num_pages, int page_size, int np_tab, int h, long long q_sb, long long q_st,
    long long q_sn, long long o_sb, long long o_st, long long o_sn, int window,
    float scale, int is_bf16, int br, void* stream) {
  gqa_tile::Args a{q, k_pool, v_pool, k_scale, v_scale, q_positions, kv_lens, q_lens,
                   out, b, t, n, kh, q_sb, q_st, q_sn, o_sb, o_st, o_sn, window, scale,
                   static_cast<cudaStream_t>(stream)};
  const PagedSrc src{static_cast<const int*>(table), num_pages, kh, page_size, np_tab};
  return gqa_tile::launch_any<true>(a, src, h, is_bf16, br);
}
