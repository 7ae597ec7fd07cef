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
// putting the table in the DMA engine's index map; here every block looks up
// the page of each key slot itself, so a row streams only its live pages,
// straight from the pool.
//
// Design: the tile kernel of `gqa_tile.cuh` (shared with the contiguous
// flash kernel), with key slot s of (b, kv head kh) found through the table:
// row (page * K + kh) * PS + s % PS. One block per (row b, KV head, tile of
// BR folded rows r = g * T + t, the JAX fold). The block's KV loop runs from
// the first slot its rows' window can see to min(kv_lens[b], the tile's max
// live position + 1), in tiles of 64 slots, each [H] row loaded with
// cp.async; slots outside that range, and slots whose table entry is the
// sentinel or out of range, are zero-filled and never read, so a sentinel
// page is never touched and NaN in dead offsets never reaches the sum.
// Page sizes: any multiple of 8 (a tile may span several pages, or part of
// one). Decode (T == 1) uses BR = the next power of two >= G (up to 16),
// query windows BR = 16.

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
extern "C" int ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* q_positions, const void* kv_lens, const void* q_lens, void* out,
    int b, int t, int n, int kh, int num_pages, int page_size, int np_tab,
    int h, long long q_sb, long long q_st, long long q_sn, long long o_sb,
    long long o_st, long long o_sn, int window, float scale, int is_bf16,
    int br, void* stream) {
  gqa_tile::Args a{q, k_pool, v_pool, nullptr, nullptr, q_positions, kv_lens, q_lens,
                   out, b, t, n, kh, q_sb, q_st, q_sn, o_sb, o_st, o_sn, window, scale,
                   static_cast<cudaStream_t>(stream)};
  const PagedSrc src{static_cast<const int*>(table), num_pages, kh, page_size,
                     np_tab};
  return gqa_tile::launch_any<false>(a, src, h, is_bf16, br);
}
