// Flash GQA attention over the contiguous KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_gqa_attention` of the JAX package
// (llm_based_apache_spark_optimization_tpu/ops/pallas/attention.py): its
// prefill body `_flash_kernel` and its KV-head-folded decode body
// `_make_decode_kernel(dequant=False)`. Same contract:
//
//   q [B, T, N, H] (strided), k and v [B, K, S, H] contiguous, q_positions
//   [B, T] i32, kv_lens [B] i32 (clipped to [0, S]) -> out [B, T, N, H].
//
// Two kernels behind one entry point, both over the key slot s of (b, kv
// head kh) at row (b * K + kh) * S + s:
//   * bf16 prefill (T > 1): `flash_prefill.cuh`, FlashAttention-2 on the
//     tensor cores (mma.sync), 64 folded rows a block;
//   * decode (T == 1) and f32 prefill: the scalar tile kernel of
//     `gqa_tile.cuh` (row fold, KV loop, cp.async double buffering, online
//     softmax in f32), shared with the paged kernels. f32 stays off the
//     tensor cores: TF32 would miss the 1e-4 tolerance.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16):
//   decode (T == 1): the live K + V bytes, sum_b min(S, kv_lens[b]) * K * H
//     * 2 * itemsize, over 3.35 TB/s: a memory-bound read.
//   prefill (T > 1): the larger of those bytes over 3.35 TB/s and the
//     visible (row, key) pairs * 4 * H FLOPs over 989 TFLOP/s.
// Grid: bf16 prefill uses BR = 64 rows per block, f32 prefill BR = 16;
// decode uses BR = the next power of two >= G (up to 16), so one block holds
// all G rows of a (b, kv head).

#include "flash_prefill.cuh"
#include "gqa_tile.cuh"

namespace {

struct ContigSrc {
  int kv_heads, s_len;
  __device__ __forceinline__ long long row(int b, int kh, int s) const {
    return ((long long)b * kv_heads + kh) * s_len + s;
  }
  __device__ __forceinline__ int len() const { return s_len; }
};

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). Strides are in
// elements; the head dim of q and out is contiguous. `br` is the scalar
// kernel's row tile: 16 for prefill, the next power of two >= G for decode
// (the bf16 prefill kernel's tile is its own 64).
extern "C" int flash_gqa_attention(
    const void* q, const void* k, const void* v, const void* q_positions,
    const void* kv_lens, void* out, int b, int t, int n, int kh, int s, int h,
    long long q_sb, long long q_st, long long q_sn, long long o_sb,
    long long o_st, long long o_sn, int window, float scale, int is_bf16,
    int br, void* stream) {
  gqa_tile::Args a{q, k, v, nullptr, nullptr, q_positions, kv_lens, nullptr, out, b,
                   t, n, kh, q_sb, q_st, q_sn, o_sb, o_st, o_sn, window, scale,
                   static_cast<cudaStream_t>(stream)};
  if (is_bf16 && t > 1) return flash_prefill::launch_any(a, ContigSrc{kh, s}, h);
  return gqa_tile::launch_any<false>(a, ContigSrc{kh, s}, h, is_bf16, br);
}
