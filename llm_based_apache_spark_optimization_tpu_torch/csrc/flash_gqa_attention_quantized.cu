// Decode flash GQA attention over the contiguous int8 KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `flash_gqa_attention_quantized` of the JAX package
// (llm_based_apache_spark_optimization_tpu/ops/pallas/attention.py): its
// body `_make_decode_kernel(dequant=True)` with `_dequant_streams`. Same
// contract:
//
//   q [B, 1, N, H] (strided, head dim contiguous), k8 and v8 [B, K, S, H]
//   int8 contiguous, ks and vs [B, K, S] f32 (one scale per slot),
//   q_positions [B, 1] i32, kv_lens [B] i32 (clipped to [0, S]) -> out
//   [B, 1, N, H]. Slot s of (b, kh) stands for T(float(k8) * ks): K/V are
//   dequantized to the compute type before the dots, as the TPU kernel does.
//   T == 1 only (decode).
//
// What bounds it on an H100 SXM (3.35 TB/s): the live cache bytes,
// sum_b min(S, kv_lens[b]) * K * (2 * H + 8) (int8 K and V plus two f32
// scales per slot), over 3.35 TB/s: half the bytes of the bf16 decode.
//
// Design: the split-KV kernel of `decode_split.cuh` over the contiguous
// source (`kv_source::ContigSrc`), slot s of (b, kv head kh) at row
// (b * K + kh) * S + s of the values and the scales. Each (b, kv head)
// row's live range is split over a cluster of `splits` blocks (the
// wrapper's `decode_split_plan`), dequantized in registers, and the partial
// softmaxes merged in the cluster.

#include "decode_split.cuh"
#include "kv_source.cuh"

// Returns the launch's error or cudaGetLastError() after it (0 = launched).
// Strides are in elements; the head dim of q and out is contiguous.
// `splits` (1..8) is the cluster size: the blocks one row's cache is split
// over.
extern "C" int flash_gqa_attention_quantized(
    const void* q, const void* k8, const void* ks, const void* v8, const void* vs,
    const void* q_positions, const void* kv_lens, void* out, int b, int n, int kh,
    int s, int h, long long q_sb, long long q_sn, long long o_sb, long long o_sn,
    int window, float scale, int is_bf16, int splits, void* stream) {
  decode_split::Args a{q, k8, v8, ks, vs, q_positions, kv_lens, nullptr, out, b, n, kh,
                       q_sb, q_sn, o_sb, o_sn, window, scale,
                       static_cast<cudaStream_t>(stream)};
  return decode_split::launch_any<true>(a, kv_source::ContigSrc{kh, s}, h, is_bf16, splits);
}
