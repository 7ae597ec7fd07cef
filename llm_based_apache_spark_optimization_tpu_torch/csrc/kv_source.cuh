// Where key slot s of (batch row b, kv head kh) lives: the two K/V sources
// of the attention kernels (`gqa_tile.cuh`, `flash_prefill.cuh`,
// `decode_split.cuh` and, the paged one's `base` once a page,
// `window_split.cuh`), shared by every attention source of the port.
//
// A source gives the row of the slot's [H] values in the K and V arrays
// (and of its scale in an int8 cache's scale arrays), or -1 when no row
// backs it (an unmapped page):
//   * `row(b, kh, s)` looks it up from scratch (the tile kernels);
//   * `row_at(b, kh, s, cache)` may reuse the last lookup of the calling
//     lane (`RowCache`): the split decode kernel's lanes walk their slots
//     in order and read the page table once per page they enter.
// `len()` is the virtual length S that kv_lens clip to.

#pragma once

namespace kv_source {

// The row of the page a lane read last: key = the slot's page index, base =
// its first row, -1 if unmapped (a contiguous source ignores it).
struct RowCache {
  int key;
  long long base;
};

// The contiguous cache [B, K, S, H]: slot s of (b, kh) at row
// (b * K + kh) * S + s.
struct ContigSrc {
  int kv_heads, s_len;
  __device__ __forceinline__ long long row(int b, int kh, int s) const {
    return ((long long)b * kv_heads + kh) * s_len + s;
  }
  __device__ __forceinline__ long long row_at(int b, int kh, int s, RowCache&) const {
    return row(b, kh, s);
  }
  __device__ __forceinline__ int len() const { return s_len; }
};

// The page pool [P, K, PS, H] read through a table [B, NP] (unmapped entries
// hold the sentinel P, or any value outside [0, P)): logical slot s of row b
// sits on page table[b, s / PS] at offset s % PS, row
// (page * K + kh) * PS + s % PS (a page's PS scales are contiguous per
// (page, head) the same way).
struct PagedSrc {
  const int* table;  // [B, NP]
  int num_pages, kv_heads, page_size, np_tab;
  __device__ __forceinline__ long long base(int b, int kh, int pi) const {
    const int page = table[(long long)b * np_tab + pi];
    if (page < 0 || page >= num_pages) return -1;
    return ((long long)page * kv_heads + kh) * page_size;
  }
  __device__ __forceinline__ long long row(int b, int kh, int s) const {
    const long long r = base(b, kh, s / page_size);
    return r < 0 ? -1 : r + s % page_size;
  }
  // The table is read once per page a lane enters: its base row is cached.
  __device__ __forceinline__ long long row_at(int b, int kh, int s, RowCache& c) const {
    const int pi = s / page_size;
    if (pi != c.key) {
      c.key = pi;
      c.base = base(b, kh, pi);
    }
    return c.base < 0 ? -1 : c.base + (s - pi * page_size);
  }
  __device__ __forceinline__ int len() const { return np_tab * page_size; }
};

}  // namespace kv_source
