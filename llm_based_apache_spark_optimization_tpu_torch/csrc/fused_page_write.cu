// The page write into a bf16 or f32 pool: the C entry of the kernel in
// page_write.cuh, which replaces the JAX package's `_bf16_write_kernel`
// (llm_based_apache_spark_optimization_tpu/ops/pallas/paged_write.py:92,
// called at :191 by `fused_page_write`). The contract, what bounds the
// kernel and its design are in page_write.cuh.

#include "page_write.cuh"

// Returns the launch's error (0 = launched). `elem_bytes` is 2 (bf16) or 4
// (f32), the type of the slivers and the pools; hd is 64 or 128. With
// `prefetch` the kernel loads the row's table up front (np_tab <= 64).
extern "C" int fused_page_write(
    const void* k_new, const void* v_new, void* kp, void* vp,
    const void* positions, const void* table, const void* q_lens, int b,
    int t, int np_tab, int num_pages, int kv_heads, int page_size, int hd,
    int layer, int elem_bytes, int prefetch, void* stream) {
  const page_write::Args a = {
      k_new, v_new, kp, vp, nullptr, nullptr,
      static_cast<const int*>(positions), static_cast<const int*>(table),
      static_cast<const int*>(q_lens), b * t * kv_heads * 2, t, np_tab, num_pages,
      kv_heads, page_size, (long long)layer * num_pages * kv_heads * page_size, prefetch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return page_write::launch<__nv_bfloat16, __nv_bfloat16>(a, hd, s);
  if (elem_bytes == 4) return page_write::launch<float, float>(a, hd, s);
  return (int)cudaErrorInvalidValue;
}
