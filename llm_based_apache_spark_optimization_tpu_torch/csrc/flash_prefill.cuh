// The bf16 prefill launch (T > 1) of the flash GQA attention over the
// contiguous KV cache, on Hopper's tensor cores (sm_90a).
//
// Replaces the prefill body `_flash_kernel` of the TPU kernel
// `flash_gqa_attention` (llm_based_apache_spark_optimization_tpu/ops/
// pallas/attention.py). The contract is `gqa_tile.cuh`'s, for bf16 in and
// out: rows r = g*T + t fold the G query heads of a KV head; key slot s is
// visible to the query at position p iff s <= p, s < kv_lens[b] and, with
// a window w > 0, p - s < w; f32 online softmax; the probabilities are
// rounded to bf16 before the PV product (the TPU kernel's
// p.astype(v.dtype)); a row with no visible key, or a dead window column,
// returns exact zeros; slots no row of a block can see are never read
// (the copies zero-fill them), so NaN there cannot reach the result.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the
// larger of the live K + V bytes over 3.35 TB/s and 4 * H FLOPs per visible
// (row, key) pair over 989 TFLOP/s. At the 7B prompt (T = 384, S = 448) that
// is 12.6 MB of Q, live K/V and out (3.8 us) against 1.2 GFLOP of visible
// pairs (1.2 us): bytes. K/V are read once per 64 rows (the scalar kernel
// read them once per 16) and every product runs on the tensor cores.
//
// Design (FlashAttention-2 on mma.sync.m16n8k16):
//   * A block holds 64 folded rows of one (b, kv head), 16 per warp; four
//     warps. Q is copied to shared memory once and loaded into A fragments
//     by ldmatrix, kept in registers for the whole KV loop.
//   * K/V tiles of 64 slots are double buffered in shared memory through
//     `gqa_tile::load_tile` (16-byte cp.async, zero-fill outside
//     [kv_begin, kv_end)); rows padded by 16 bytes so ldmatrix reads no
//     bank twice. The block walks the same tiles as the scalar kernel:
//     from the first slot its rows' window can see to min(kv_lens, max
//     position + 1).
//   * S = Q K^T in f32 on the tensor cores (K fragments by ldmatrix), each
//     element masked with `visible()`, the online softmax in registers: the
//     row max and sum of a row live in the four lanes of a quad (two
//     shuffles), exp2 of log2-scaled scores, masked elements p = 0.
//   * P is rounded to bf16 straight from the score accumulators (the
//     m16n8 C layout is the A layout of the next product, in register
//     pairs) and multiplied with V on the tensor cores, V fragments by
//     ldmatrix.trans.
//   * The epilogue divides by the quad-summed row sum (zeros stay zeros).

#pragma once

#include <climits>

#include "gqa_tile.cuh"
#include "hopper.cuh"

namespace flash_prefill {

using bf16 = __nv_bfloat16;
using gqa_tile::kBlockKV;
using gqa_tile::kNegInf;
using gqa_tile::visible;

constexpr int kThreads = gqa_tile::kThreads;  // 4 warps (load_tile's stride)
constexpr int kRows = 64;                     // folded rows per block
static_assert(kThreads == 128 && kRows == 16 * (kThreads / 32), "16 rows a warp");

// Shared memory, bf16 rows of HD + 8 elements (16 bytes of padding):
//   K [2][64][kRow], V [2][64][kRow], Q [64][kRow].
template <int HD>
struct Layout {
  static constexpr int kRow = HD + 8;
  static constexpr size_t kTile = sizeof(bf16) * kBlockKV * kRow;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = 2 * kTile;
  static constexpr size_t q_off = 4 * kTile;
  static constexpr size_t bytes = q_off + sizeof(bf16) * kRows * kRow;
};

// One warp's FlashAttention-2 step over NKEYS (64 or 32) key slots from s0
// in shared memory (K at `kt`, V at `vt`, rows of HD + 8 bf16), for the
// warp's 16 query rows whose A fragments are `qf`: S = Q K^T on the tensor
// cores,
// each score masked with `visible()` (the lane's two rows at positions
// pos_a, pos_b), the online softmax in registers (row max and sum over a
// quad), P rounded to bf16 and O += P V. m and l are the lane's running
// max (log2 domain) and partial sum of its two rows; o the accumulators
// (o[n][e]: row gid + 8 (e / 2), column 8n + 2 tig + e % 2). Shared by the
// contiguous bf16 prefill and the paged query windows (`window_split.cuh`).
template <int HD, int NKEYS = kBlockKV>
__device__ __forceinline__ void warp_tile_step(const uint32_t (&qf)[HD / 16][4],
                                               const bf16* kt, const bf16* vt, int s0,
                                               int pos_a, int pos_b, int kvl, int window,
                                               float scale_log2, float& m_a, float& m_b,
                                               float& l_a, float& l_b,
                                               float (&o)[HD / 8][4], int lane) {
  constexpr int ROW = HD + 8;
  constexpr int KS = HD / 16;
  constexpr int NJ = NKEYS / 8;  // key tiles of 8
  static_assert(NKEYS == 64 || NKEYS == 32, "64 or 32 keys a step");
  const int tig = lane % 4;
  // S = Q K^T: NJ tiles of 8 keys; ldmatrix.x4 gives two key tiles' B.
  float s[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int np = 0; np < NJ / 2; ++np) {
      uint32_t kb[4];
      hopper::ldsm_x4(kb, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ROW +
                              kk * 16 + ((lane >> 3) & 1) * 8);
      hopper::mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
      hopper::mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
    }
  }

  // Mask and scale; s[j][e] is (row gid + 8 * (e / 2), key 8j + 2tig + e % 2).
  uint32_t vis = 0u;
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = s0 + 8 * j + 2 * tig + (e & 1);
      const bool ok = visible(key, e < 2 ? pos_a : pos_b, kvl, window);
      s[j][e] = ok ? s[j][e] * scale_log2 : kNegInf;
      vis |= (ok ? 1u : 0u) << (4 * j + e);
      if (e < 2) mx_a = fmaxf(mx_a, s[j][e]);
      else mx_b = fmaxf(mx_b, s[j][e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;

  // P: masked entries exactly 0 (a row masked so far keeps m = NEG_INF,
  // and exp(NEG_INF - NEG_INF) = 1 would pollute l), rounded to bf16 as
  // the A fragments of P V: tile 2kk + h gives a[2h] (row gid), a[2h+1].
  uint32_t pf[NJ / 2][4];
  float ls_a = 0.f, ls_b = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = (vis >> (4 * j + e)) & 1u ? exp2f(s[j][e] - (e < 2 ? m_a : m_b)) : 0.f;
    ls_a += p[0] + p[1];
    ls_b += p[2] + p[3];
    pf[j / 2][2 * (j % 2)] = hopper::pack_bf16(p[0], p[1]);
    pf[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(p[2], p[3]);
  }
  l_a = alpha_a * l_a + ls_a;
  l_b = alpha_b * l_b + ls_b;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    o[n][0] *= alpha_a;
    o[n][1] *= alpha_a;
    o[n][2] *= alpha_b;
    o[n][3] *= alpha_b;
  }

  // O += P V: ldmatrix.trans gives two column tiles' B per 16 keys.
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
#pragma unroll
    for (int np = 0; np < KS; ++np) {
      uint32_t vb[4];
      hopper::ldsm_x4_trans(vb, vt + (kk * 16 + (lane & 15)) * ROW + np * 16 + (lane >> 4) * 8);
      hopper::mma_bf16(o[2 * np], pf[kk], vb[0], vb[1]);
      hopper::mma_bf16(o[2 * np + 1], pf[kk], vb[2], vb[3]);
    }
  }
}

template <int HD, typename Src>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const Src src,
                     const int* __restrict__ qpos, const int* __restrict__ kv_lens,
                     const int* __restrict__ q_lens, bf16* __restrict__ out,
                     int t_len, int n_heads, int kv_heads,
                     long long q_sb, long long q_st, long long q_sn,
                     long long o_sb, long long o_st, long long o_sn,
                     int window, float scale_log2) {
  using L = Layout<HD>;
  constexpr int ROW = L::kRow;
  constexpr int KS = HD / 16;  // k-steps of Q K^T; also V column-tile pairs

  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  __shared__ int s_min[kThreads / 32], s_max[kThreads / 32];

  const int g_size = n_heads / kv_heads;
  const int rows = g_size * t_len;
  const int b = blockIdx.x / kv_heads;
  const int kh = blockIdx.x % kv_heads;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int q_live = q_lens ? q_lens[b] : t_len;

  // Position of block row r (-1: past the rows, or a dead window column).
  auto row_pos = [&](int r) {
    const int row = row0 + r, t = row % t_len;
    return (row < rows && t < q_live) ? qpos[(long long)b * t_len + t] : -1;
  };
  const int pos_a = row_pos(warp * 16 + gid);  // this lane's two rows
  const int pos_b = row_pos(warp * 16 + gid + 8);

  // The block's least and largest live position bound the KV walk.
  {
    int mn = INT_MAX, mx = -1;
    if (tid < kRows) {
      const int p = row_pos(tid);
      if (p >= 0) mn = mx = p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
      s_min[warp] = mn;
      s_max[warp] = mx;
    }
  }
  // Q rows into shared memory, 16 bytes a copy; rows past the end are zero.
  for (int i = tid; i < kRows * HD / 8; i += kThreads) {
    const int r = i / (HD / 8), h = (i % (HD / 8)) * 8, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) {
      const int g = row / t_len, t = row % t_len;
      val = *reinterpret_cast<const uint4*>(
          q + b * q_sb + t * q_st + (long long)(kh * g_size + g) * q_sn + h);
    }
    *reinterpret_cast<uint4*>(Qs + r * ROW + h) = val;
  }
  __syncthreads();
  int minpos = INT_MAX, maxpos = -1;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    minpos = min(minpos, s_min[w]);
    maxpos = max(maxpos, s_max[w]);
  }
  const int kvl = min(max(kv_lens[b], 0), src.len());
  const int kv_end = min(kvl, maxpos + 1);  // exclusive; <= 0 means no tile
  int kv_begin = 0;
  if (window > 0 && kv_end > 0) kv_begin = max(0, minpos - window + 1);

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    hopper::ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * ROW + kk * 16 + (lane >> 4) * 8);

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  int s0 = kv_begin / kBlockKV * kBlockKV;
  if (s0 < kv_end) {
    gqa_tile::load_tile<bf16, HD, Src, ROW>(Ks, Vs, k, v, src, b, kh, s0, kv_begin, kv_end,
                                            tid);
  }
  hopper::cp_async_commit();
  for (int stage = 0; s0 < kv_end; s0 += kBlockKV, stage ^= 1) {
    if (s0 + kBlockKV < kv_end) {
      gqa_tile::load_tile<bf16, HD, Src, ROW>(Ks + (stage ^ 1) * kBlockKV * ROW,
                                              Vs + (stage ^ 1) * kBlockKV * ROW, k, v, src,
                                              b, kh, s0 + kBlockKV, kv_begin, kv_end, tid);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = Ks + stage * kBlockKV * ROW;
    const bf16* vt = Vs + stage * kBlockKV * ROW;

    warp_tile_step<HD>(qf, kt, vt, s0, pos_a, pos_b, kvl, window, scale_log2, m_a, m_b, l_a,
                       l_b, o, lane);
    __syncthreads();  // this stage is free for the copies two tiles on
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + warp * 16 + gid + 8 * half;
    if (row >= rows) continue;
    const int g = row / t_len, t = row % t_len;
    bf16* dst = out + b * o_sb + t * o_st + (long long)(kh * g_size + g) * o_sn + 2 * tig;
    const float inv = half ? inv_b : inv_a;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          hopper::pack_bf16(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    }
  }
}

template <int HD, typename Src>
int launch(const gqa_tile::Args& a, const Src& src) {
  constexpr size_t smem = Layout<HD>::bytes;
  auto kernel = flash_prefill_kernel<HD, Src>;
  static bool opted_in = false;  // above 48 KB, opt in once
  if (!opted_in) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int rows = (a.n / a.kh) * a.t;
  const dim3 grid(a.b * a.kh, (rows + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), src, static_cast<const int*>(a.qpos),
      static_cast<const int*>(a.kv_lens), static_cast<const int*>(a.q_lens),
      static_cast<bf16*>(a.out), a.t, a.n, a.kh, a.q_sb, a.q_st, a.q_sn, a.o_sb, a.o_st,
      a.o_sn, a.window, a.scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// Head dims 64 and 128; returns cudaGetLastError() after the launch.
template <typename Src>
int launch_any(const gqa_tile::Args& a, const Src& src, int h) {
  if (h == 64) return launch<64>(a, src);
  if (h == 128) return launch<128>(a, src);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_prefill
