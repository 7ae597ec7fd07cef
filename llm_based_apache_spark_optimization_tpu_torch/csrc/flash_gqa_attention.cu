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
// Three kernels behind one entry point, all over the key slot s of (b, kv
// head kh) at row (b * K + kh) * S + s (`kv_source::ContigSrc`):
//   * decode (T == 1, `splits` >= 1): the split-KV kernel of
//     `decode_split.cuh`, shared with every other decode launch: each (b,
//     kv head) row's live range split over a thread-block cluster of
//     `splits` blocks (the wrapper's `decode_split_plan`), K/V in
//     registers, the partial softmaxes merged in the cluster;
//   * bf16 prefill (T > 1): `flash_prefill.cuh`, FlashAttention-2 on the
//     tensor cores (mma.sync), 64 folded rows a block;
//   * f32 prefill (T > 1): the scalar tile kernel of `gqa_tile.cuh` (row
//     fold, KV loop, cp.async double buffering, online softmax in f32), 16
//     folded rows a block, shared with the paged query windows. f32 stays
//     off the tensor cores: TF32 would miss the 1e-4 tolerance.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16):
//   decode (T == 1): the live K + V bytes, sum_b min(S, kv_lens[b]) * K * H
//     * 2 * itemsize, over 3.35 TB/s: a memory-bound read.
//   prefill (T > 1): the larger of those bytes over 3.35 TB/s and the
//     visible (row, key) pairs * 4 * H FLOPs over 989 TFLOP/s.

#include "decode_split.cuh"
#include "flash_prefill.cuh"
#include "gqa_tile.cuh"
#include "kv_source.cuh"

// Returns the launch's error or cudaGetLastError() after it (0 = launched).
// Strides are in elements; the head dim of q and out is contiguous.
// `splits` (1..8, T == 1 only) is the decode kernel's cluster size: the
// blocks one row's cache is split over; 0 for a prefill (T > 1).
extern "C" int flash_gqa_attention(
    const void* q, const void* k, const void* v, const void* q_positions,
    const void* kv_lens, void* out, int b, int t, int n, int kh, int s, int h,
    long long q_sb, long long q_st, long long q_sn, long long o_sb,
    long long o_st, long long o_sn, int window, float scale, int is_bf16,
    int splits, void* stream) {
  const kv_source::ContigSrc src{kh, s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((splits > 0) != (t == 1)) return (int)cudaErrorInvalidValue;
  if (splits > 0) {
    decode_split::Args a{q, k, v, nullptr, nullptr, q_positions, kv_lens, nullptr, out,
                         b, n, kh, q_sb, q_sn, o_sb, o_sn, window, scale, st};
    return decode_split::launch_any<false>(a, src, h, is_bf16, splits);
  }
  gqa_tile::Args a{q, k, v, nullptr, nullptr, q_positions, kv_lens, nullptr, out, b,
                   t, n, kh, q_sb, q_st, q_sn, o_sb, o_st, o_sn, window, scale, st};
  if (is_bf16) return flash_prefill::launch_any(a, src, h);
  if (h == 64) return gqa_tile::launch<float, float, 64>(a, src);  // f32 prefill
  if (h == 128) return gqa_tile::launch<float, float, 128>(a, src);
  return (int)cudaErrorInvalidValue;
}
