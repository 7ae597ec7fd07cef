// Fused page write: scatter fresh K/V slivers into the page pool through the
// page table, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_page_write` of the JAX package
// (llm_based_apache_spark_optimization_tpu/ops/pallas/paged_write.py): its
// body `_bf16_write_kernel` with coordinates from `_coords`. Same contract:
//
//   k_new, v_new [B, T, K, H] contiguous, in the pool's type; pools kp, vp
//   [L, P, K, PS, H] contiguous, written in place at the static `layer`;
//   positions [B, T] i32; page_table [B, NP] i32; optional q_lens [B] i32.
//   Sliver (b, t) lands at kp[layer, page, :, off, :] with
//   page = page_table[b, pos / PS] and off = pos % PS. It is dropped (writes
//   nothing) when pos < 0, pos / PS >= NP (past the row), t >= q_lens[b]
//   (a dead window column), or the table entry is the sentinel (or any
//   value outside [0, P)). A pure copy: the result is bit for bit the plain
//   version's.
//
// What bounds it on an H100 SXM (3.35 TB/s): the sliver bytes, read once and
// written once: 2 * B * T * K * H * itemsize * 2, over 3.35 TB/s. At decode
// that is a few hundred KB, so the launch is latency bound.
//
// Design: one block per (b, t) sliver computes its page and offset from the
// table itself (the TPU kernel had them precomputed in scalar prefetch) and
// copies the K and V slivers, [K, H] each, with 16-byte loads and stores
// (one per thread per step; neighbouring threads on neighbouring addresses).
// K and V land in one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_page_write_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                        T* __restrict__ kp, T* __restrict__ vp,
                        const int* __restrict__ positions,
                        const int* __restrict__ table,
                        const int* __restrict__ q_lens, int t_len, int np_tab,
                        int num_pages, int kv_heads, int page_size, int hd,
                        long long layer_off) {
  const int b = blockIdx.x / t_len, t = blockIdx.x % t_len;
  const int pos = positions[(long long)b * t_len + t];
  if (pos < 0) return;
  const int pi = pos / page_size;
  if (pi >= np_tab) return;
  if (q_lens != nullptr && t >= min(max(q_lens[b], 0), t_len)) return;
  const int page = table[(long long)b * np_tab + pi];
  if (page < 0 || page >= num_pages) return;
  const int off = pos % page_size;

  constexpr int VEC = 16 / sizeof(T);
  const long long src0 = ((long long)b * t_len + t) * kv_heads * hd;
  const uint4* ks = reinterpret_cast<const uint4*>(k_new + src0);
  const uint4* vs = reinterpret_cast<const uint4*>(v_new + src0);
  const int chunks = kv_heads * hd / VEC;
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const int e = i * VEC, kh = e / hd, h = e % hd;
    const long long dst =
        layer_off + (((long long)page * kv_heads + kh) * page_size + off) * hd + h;
    *reinterpret_cast<uint4*>(kp + dst) = ks[i];
    *reinterpret_cast<uint4*>(vp + dst) = vs[i];
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). `elem_bytes`
// is 2 (bf16) or 4 (f32); hd * elem_bytes must be a multiple of 16.
extern "C" int fused_page_write(
    const void* k_new, const void* v_new, void* kp, void* vp,
    const void* positions, const void* table, const void* q_lens, int b,
    int t, int np_tab, int num_pages, int kv_heads, int page_size, int hd,
    int layer, int elem_bytes, void* stream) {
  const long long layer_off =
      (long long)layer * num_pages * kv_heads * page_size * hd;
  const dim3 grid(b * t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  const int* tab = static_cast<const int*>(table);
  const int* ql = static_cast<const int*>(q_lens);
  if (b * t == 0) return 0;
  if (elem_bytes == 2) {
    fused_page_write_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new),
        static_cast<__nv_bfloat16*>(kp), static_cast<__nv_bfloat16*>(vp), pos,
        tab, ql, t, np_tab, num_pages, kv_heads, page_size, hd, layer_off);
  } else if (elem_bytes == 4) {
    fused_page_write_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(k_new), static_cast<const float*>(v_new),
        static_cast<float*>(kp), static_cast<float*>(vp), pos, tab, ql, t,
        np_tab, num_pages, kv_heads, page_size, hd, layer_off);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
