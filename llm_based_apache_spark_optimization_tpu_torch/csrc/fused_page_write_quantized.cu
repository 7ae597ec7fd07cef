// Quantizing fused page write: int8 K/V slivers and their scales into the
// page pool through the page table, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_page_write_quantized` of the JAX package
// (llm_based_apache_spark_optimization_tpu/ops/pallas/paged_write.py): its
// body `_quant_write_kernel` with coordinates from `_coords`. Same contract:
//
//   k_new, v_new [B, T, K, H] contiguous, bf16 or f32; pools kp, vp
//   [L, P, K, PS, H] int8 and scales kps, vps [L, P, K, PS] f32, contiguous,
//   written in place at the static `layer`; positions [B, T] i32;
//   page_table [B, NP] i32; optional q_lens [B] i32. Each (b, t, kv head)
//   row x [H] is quantized as the JAX package's `quantize_kv`:
//     s = max|x| / 127 (1 when that is 0), q = clamp(rint(x / s), -127, 127)
//   in f32 with true IEEE division (nvcc's default; no fast-math flag), and
//   lands at page = page_table[b, pos / PS], offset pos % PS. A sliver is
//   dropped (writes nothing) when pos < 0, pos / PS >= NP, t >= q_lens[b],
//   or the table entry is outside [0, P). The result is bit for bit the
//   plain version's: the max is exact in any order and every other step is
//   one correctly rounded f32 operation.
//
// What bounds it on an H100 SXM (3.35 TB/s): the sliver bytes, read once
// (2 * B * T * K * H * itemsize) and written once as int8 values plus f32
// scales (2 * B * T * K * (H + 4)), over 3.35 TB/s. At decode that is a
// few hundred KB, so the launch is latency bound.
//
// Design: blocks of four warps, grid (B * T, ceil(2K / 4)): each block
// computes its sliver's page and offset from the table (the TPU kernel had
// them in scalar prefetch), and each warp quantizes one (kv head, K or V)
// row: every lane holds H/32 values, a shuffle reduction gives the absmax,
// and the lane stores its int8 values (4 or 2 bytes) while lane 0 stores
// the scale. One row per warp keeps the launch's latency to one chain of
// load, reduction, division and store: a decode step has only B slivers,
// each of 2K = 64 rows at 7B. K and V land in one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fused_page_write_quantized_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                                  int8_t* __restrict__ kp, float* __restrict__ kps,
                                  int8_t* __restrict__ vp, float* __restrict__ vps,
                                  const int* __restrict__ positions,
                                  const int* __restrict__ table,
                                  const int* __restrict__ q_lens, int t_len, int np_tab,
                                  int num_pages, int kv_heads, int page_size,
                                  long long layer_slots) {
  constexpr int PER = HD / 32;  // values per lane
  const int b = blockIdx.x / t_len, t = blockIdx.x % t_len;
  const int pos = positions[(long long)b * t_len + t];
  if (pos < 0) return;
  const int pi = pos / page_size;
  if (pi >= np_tab) return;
  if (q_lens != nullptr && t >= min(max(q_lens[b], 0), t_len)) return;
  const int page = table[(long long)b * np_tab + pi];
  if (page < 0 || page >= num_pages) return;
  const int off = pos % page_size;
  const int task = blockIdx.y * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (task < 2 * kv_heads) {
    const int kh = task >> 1;
    const bool is_v = task & 1;
    const T* src = (is_v ? v_new : k_new) +
                   (((long long)b * t_len + t) * kv_heads + kh) * HD + lane * PER;
    float x[PER];
    float m = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      x[e] = to_f32(src[e]);
      m = fmaxf(m, fabsf(x[e]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float s = m / 127.0f;
    if (s == 0.f) s = 1.f;
    const long long slot = layer_slots + ((long long)page * kv_heads + kh) * page_size + off;
    int8_t q[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e)
      q[e] = (int8_t)fminf(fmaxf(rintf(x[e] / s), -127.f), 127.f);
    int8_t* dst = (is_v ? vp : kp) + slot * HD + lane * PER;
    if constexpr (PER == 4) {
      *reinterpret_cast<char4*>(dst) = make_char4(q[0], q[1], q[2], q[3]);
    } else {
      *reinterpret_cast<char2*>(dst) = make_char2(q[0], q[1]);
    }
    if (lane == 0) (is_v ? vps : kps)[slot] = s;
  }
}

template <typename T, int HD>
void launch(const void* k_new, const void* v_new, void* kp, void* kps, void* vp, void* vps,
            const int* pos, const int* tab, const int* ql, int b, int t, int np_tab,
            int num_pages, int kv_heads, int page_size, long long layer_slots,
            cudaStream_t s) {
  const dim3 grid(b * t, (2 * kv_heads + kWarps - 1) / kWarps);
  fused_page_write_quantized_kernel<T, HD><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<int8_t*>(kp), static_cast<float*>(kps), static_cast<int8_t*>(vp),
      static_cast<float*>(vps), pos, tab, ql, t, np_tab, num_pages, kv_heads, page_size,
      layer_slots);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). `elem_bytes`
// is the slivers' type: 2 (bf16) or 4 (f32); hd is 64 or 128.
extern "C" int fused_page_write_quantized(
    const void* k_new, const void* v_new, void* kp, void* kps, void* vp, void* vps,
    const void* positions, const void* table, const void* q_lens, int b, int t,
    int np_tab, int num_pages, int kv_heads, int page_size, int hd, int layer,
    int elem_bytes, void* stream) {
  if (b * t == 0) return 0;
  const long long layer_slots = (long long)layer * num_pages * kv_heads * page_size;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* pos = static_cast<const int*>(positions);
  const int* tab = static_cast<const int*>(table);
  const int* ql = static_cast<const int*>(q_lens);
  if (hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 2) {
    if (hd == 64)
      launch<__nv_bfloat16, 64>(k_new, v_new, kp, kps, vp, vps, pos, tab, ql, b, t, np_tab,
                                num_pages, kv_heads, page_size, layer_slots, s);
    else
      launch<__nv_bfloat16, 128>(k_new, v_new, kp, kps, vp, vps, pos, tab, ql, b, t, np_tab,
                                 num_pages, kv_heads, page_size, layer_slots, s);
  } else if (elem_bytes == 4) {
    if (hd == 64)
      launch<float, 64>(k_new, v_new, kp, kps, vp, vps, pos, tab, ql, b, t, np_tab,
                        num_pages, kv_heads, page_size, layer_slots, s);
    else
      launch<float, 128>(k_new, v_new, kp, kps, vp, vps, pos, tab, ql, b, t, np_tab,
                         num_pages, kv_heads, page_size, layer_slots, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
