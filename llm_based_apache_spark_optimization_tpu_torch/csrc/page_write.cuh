// The page write, for Hopper (sm_90a): scatter fresh K/V slivers into the
// page pool through the page table, in place, either as a copy (bf16 and f32
// pools) or quantized to int8 with one f32 scale per (slot, kv head). One
// kernel serves both, templated on the sliver type, the pool's storage and H.
//
// Replaces the bodies of the JAX package's two page-write TPU kernels
// (llm_based_apache_spark_optimization_tpu/ops/pallas/paged_write.py):
//   - `_bf16_write_kernel` (:92, its pallas_call at :191, `fused_page_write`),
//     through the entry of fused_page_write.cu;
//   - `_quant_write_kernel` (:114, its pallas_call at :249,
//     `fused_page_write_quantized`), through fused_page_write_quantized.cu.
// Their coordinates came from `_coords` in scalar prefetch; here each row
// finds its own. Contract of both:
//
//   k_new, v_new [B, T, K, H] contiguous, H = 64 or 128; pools kp, vp
//   [L, P, K, PS, H] contiguous, written in place at the static `layer`
//   (int8 pools with scales kps, vps [L, P, K, PS] f32); positions [B, T]
//   i32; page_table [B, NP] i32; optional q_lens [B] i32. Sliver (b, t)
//   lands at page = page_table[b, pos / PS], offset pos % PS. It is dropped
//   (writes nothing) when pos < 0, pos / PS >= NP (past the row), t >=
//   q_lens[b] (a dead window column), or the table entry is outside
//   [0, P) (the sentinel). The copy is bit for bit. The int8 pool takes
//   `quantize_kv`'s s = max|x| / 127 (1 when that is 0) and
//   q = clamp(rint(x / s), -127, 127) in f32 with IEEE division (nvcc's
//   default; no fast-math flag), so it too is bit for bit the plain
//   version's: the max is exact in any order, and every other step is one
//   correctly rounded f32 operation.
//
// What bounds it on an H100 SXM: not bytes. A 7B decode step writes
// 2 * B * K * H values a layer (256 KB in bf16 at B = 8), 0.08 us at
// 3.35 TB/s, and one call takes microseconds: the launch, then a chain of
// dependent memory round trips (the producer's tail, the position, the table
// entry it selects, the store), each a few hundred ns.
//
// What the design does about it:
//   - Work split: one half-warp a row, a row being (sliver b * t, kv head, K
//     or V); B * T * K * 2 rows, 8 a block of four warps (64 blocks at the
//     7B decode, where one block a sliver gave 8). A lane owns H / 16 values:
//     16 bytes of bf16 at H = 128, 32 bytes of f32. The two halves of a warp
//     hold the K and the V row of one (sliver, kv head), so every coordinate
//     is uniform over the warp.
//   - Short chain: every lane issues the loads that need no coordinate
//     first: its share of the row, positions[b, t], q_lens[b], and, when the
//     wrapper asks (`prefetch`, at most 64 table pages), the row's whole
//     page table, one or two entries a lane over the warp. The entry
//     pos / PS then comes from a shuffle, not a second round trip. A dropped
//     row leaves as soon as its position is in. The int8 pool widens its
//     values to f32 in registers, takes max|x| by xor shuffles over the
//     half-warp, and divides and rounds: that arithmetic outlasts a load, so
//     the int8 pool takes no prefetch and its entry's load is in flight
//     while it quantizes. The store comes last, 8 bytes of int8 a lane at
//     H = 128, and lane 0 of the half stores the scale.
//   - Programmatic dependent launch (`hopper::launch_pdl`): the launch and
//     the block scheduling overlap the end of the producer (the RoPE of k,
//     or the wrapper's int32 cast of the positions or the table). PyTorch's
//     kernels trigger no early start, so the overlap begins when the
//     producer's last block exits and hides its grid's completion and this
//     launch. The kernel reads no global memory before
//     `grid_dependency_wait`, which returns once that producer has finished
//     and its writes are visible. It triggers no dependent: the attention
//     that follows is launched plainly and waits for the whole write.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace page_write {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = kThreads / 16;  // a half-warp a row
constexpr int kPrefetchPages = 64;            // two table entries a lane

struct Args {
  const void* k_new;
  const void* v_new;
  void* kp;      // [L, P, K, PS, H] of S
  void* vp;
  float* kps;    // [L, P, K, PS] f32, int8 pools only
  float* vps;
  const int* positions;  // [B, T]
  const int* table;      // [B, NP]
  const int* q_lens;     // [B] or null
  int rows;              // B * T * K * 2
  int t_len, np_tab, num_pages, kv_heads, page_size;
  long long layer_slots;  // layer * P * K * PS
  int prefetch;           // load the row's table up front (np_tab <= kPrefetchPages)
};

// N bytes of a lane (4, 8, 16 or 32) as 32-bit words, moved in the widest
// accesses their alignment allows.
template <int N>
struct Words {
  uint32_t w[N / 4];
};

template <int N>
__device__ __forceinline__ Words<N> load(const void* p) {
  Words<N> r;
  if constexpr (N == 4) {
    r.w[0] = *static_cast<const uint32_t*>(p);
  } else if constexpr (N == 8) {
    const uint2 u = *static_cast<const uint2*>(p);
    r.w[0] = u.x;
    r.w[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 u = static_cast<const uint4*>(p)[i];
      r.w[4 * i] = u.x;
      r.w[4 * i + 1] = u.y;
      r.w[4 * i + 2] = u.z;
      r.w[4 * i + 3] = u.w;
    }
  }
  return r;
}

template <int N>
__device__ __forceinline__ void store(void* p, const Words<N>& r) {
  if constexpr (N == 4) {
    *static_cast<uint32_t*>(p) = r.w[0];
  } else if constexpr (N == 8) {
    *static_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 16; ++i)
      static_cast<uint4*>(p)[i] =
          make_uint4(r.w[4 * i], r.w[4 * i + 1], r.w[4 * i + 2], r.w[4 * i + 3]);
  }
}

// Value e of a lane's words, widened to f32 exactly (bf16: the low half of a
// word is the lower index).
template <typename T, int N>
__device__ __forceinline__ float widen(const Words<N>& x, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(x.w[e]);
  } else {
    const uint32_t w = x.w[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <typename T, typename S, int H>
__global__ void __launch_bounds__(kThreads) page_write_kernel(const Args a) {
  constexpr bool kQuant = std::is_same<S, int8_t>::value;
  constexpr int V = H / 16;  // values a lane
  constexpr int IN = V * (int)sizeof(T), OUT = V * (int)sizeof(S);
  const int lane = threadIdx.x & 31, hl = lane & 15;
  const bool is_v = lane & 16;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 4);
  // rows is even and a warp holds rows 2w (K) and 2w + 1 (V), so whole warps
  // leave here and every shuffle below has all 32 lanes.
  if (row >= a.rows) return;
  const int bt = row / (2 * a.kv_heads), kh = (row >> 1) % a.kv_heads;
  const int b = bt / a.t_len, t = bt - b * a.t_len;
  const T* in = static_cast<const T*>(is_v ? a.v_new : a.k_new) +
                ((long long)bt * a.kv_heads + kh) * H + hl * V;
  const int* tab = a.table + (long long)b * a.np_tab;

  hopper::grid_dependency_wait();  // no global read above this line
  const Words<IN> x = load<IN>(in);
  const int pos = a.positions[bt];
  const int live = a.q_lens == nullptr ? a.t_len : min(max(a.q_lens[b], 0), a.t_len);
  int e0 = -1, e1 = -1;
  if (a.prefetch) {
    if (lane < a.np_tab) e0 = tab[lane];
    if (lane + 32 < a.np_tab) e1 = tab[lane + 32];
  }

  // pos, and so pi and every drop below, is the same over the warp: whole
  // warps leave, and a dropped row quantizes nothing.
  const int pi = pos < 0 ? -1 : pos / a.page_size;
  int page = -1;
  if (a.prefetch) page = __shfl_sync(0xffffffffu, pi < 32 ? e0 : e1, pi & 31);
  if (pi < 0 || pi >= a.np_tab || t >= live) return;
  if (!a.prefetch) page = tab[pi];  // in flight while the int8 pool quantizes

  Words<OUT> out;
  float s = 1.f;
  if constexpr (kQuant) {
    float v[V];
    float m = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      v[e] = widen<T>(x, e);
      m = fmaxf(m, fabsf(v[e]));
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    s = m / 127.0f;
    if (s == 0.f) s = 1.f;
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      uint32_t w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = (int)fminf(fmaxf(rintf(v[4 * i + j] / s), -127.f), 127.f);
        w |= (uint32_t)(q & 0xff) << (8 * j);
      }
      out.w[i] = w;
    }
  } else {
    out = x;
  }

  if (page < 0 || page >= a.num_pages) return;
  const long long slot =
      a.layer_slots + ((long long)page * a.kv_heads + kh) * a.page_size + pos % a.page_size;
  store<OUT>(static_cast<S*>(is_v ? a.vp : a.kp) + slot * H + hl * V, out);
  if constexpr (kQuant) {
    if (hl == 0) (is_v ? a.vps : a.kps)[slot] = s;
  }
}

// One launch over a.rows rows (nothing to launch at 0); hd is 64 or 128.
// Returns the launch's error (0 = launched).
template <typename T, typename S>
int launch(const Args& a, int hd, cudaStream_t st) {
  if (a.rows == 0) return 0;
  if (a.prefetch && a.np_tab > kPrefetchPages) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (hd == 64) return hopper::launch_pdl(page_write_kernel<T, S, 64>, grid, kThreads, 0, st, a);
  if (hd == 128)
    return hopper::launch_pdl(page_write_kernel<T, S, 128>, grid, kThreads, 0, st, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace page_write
