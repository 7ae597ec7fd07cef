// int8 weight-only matmul, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package computes this function without
// Pallas: its `ops/quant.py` `mm` hands XLA a `dot_general` of x against
// the int8 array with f32 accumulation and the scale in the epilogue, and
// `models/llama.py` does the same for the int8 unembed table. PyTorch has
// no bf16 x int8 product: the only library route, `x @ dequantize(w)`,
// writes a bf16 copy of each weight on every call and reads it back (5x the
// int8 bytes), so int8 weights would serve slower than bf16 ones. This
// kernel reads the int8 bytes once. Contract (JAX's):
//
//   layout io: x [R, IN] (bf16 or f32, row stride ldx), q8 [IN, OUT] int8,
//     s [OUT] f32 -> out [R, OUT] in x's type,
//       out[r, o] = T((sum_i x[r, i] * q8[i, o]) * s[o]);
//   layout vd (the unembed, a [V, D] table read as it is stored, never
//     transposed or copied): x [R, D], q8 [V, D], s [V] -> out [R, V] f32,
//       out[r, v] = (sum_d x[r, d] * q8[v, d]) * s[v].
//
// The sum runs in f32 and the scale multiplies the sum, never the weight:
// an int8 value is exact in bf16 and in f32, and each product x * q is exact
// in f32, so only the order of the f32 sums differs from the plain version.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16):
//   decode (R <= 8): the weight bytes, IN * OUT + OUT * 4, read once (7B's
//     wg: 45.1 MB, 13.5 us; the 7B unembed 131 MB, 39 us). Reaching that
//     rate takes about 3.4 MB in flight across the card (3.35 TB/s times
//     about 1 us of latency), and, per weight, few enough instructions for
//     an SM to turn ~15 weights a cycle into products.
//   verify and prefill (R > 8): the weight bytes up to R of about 100,
//     then 2 * R * IN * OUT operations over the tensor cores (wg at R =
//     1024: 92 GFLOP, 93 us), which only wgmma reaches.
//
// Design. Three kernels; the Python wrapper picks one by a single rule
// (`int8mm.int8_route`), sizes it by another (`int8mm.split_plan`) and
// passes the route, the tile and the split:
//   * The conversion (both tensor-core routes): two int8 values, bytes 0
//     and 2 of a word, become one exact bf16x2 register in three
//     instructions: the low 7 bits go into the mantissa of 2**7 (128 + (q &
//     127), a bf16 with 7 mantissa bits), the sign bit picks -128 or -256,
//     and one bf16x2 FMA adds the two (every value is an integer of at most
//     8 significant bits: exact). One byte_perm puts the pair in place.
//   * Decode (bf16, R <= 8): the operands swapped, as the int4 decode
//     kernel does: the converted weight is the A operand of
//     mma.sync.m16n8k16 (16 outputs x 16 contraction values) and x^T is B
//     (n = 8), so R = 8 costs the instructions of R = 1. A block owns BN =
//     16 C output columns (io, C = 8, 4, 2 or 1, picked so the grid fills
//     the card) or 64 table rows (vd), and streams its share of the
//     contraction through a 6-stage ring of 8 KB stages of 16-byte cp.async
//     copies, five stages (40 KB) in flight behind the math; x is staged
//     once per block. Eight warps, each taking 16 outputs x 64 contraction
//     values of every stage. The k order inside a 32-value step is permuted
//     alike in A and B so that a lane's x is one 16-byte read: vd takes
//     values 8 tig + j of a table row (one 8-byte read a row), io takes
//     rows tig + 4 j, so that the four tig read four adjacent rows, 2 bytes
//     a lane, at offsets fixed at compile time (rows padded to spread the
//     banks), and x is staged permuted to match. The io contraction axis is
//     split over a thread-block cluster of up to 8 blocks; the warps' and
//     then the blocks' partial tiles are added in a fixed order, the latter
//     through distributed shared memory in cluster-rank order. One launch,
//     no atomics: the same bits from launch to launch.
//   * Verify and prefill (bf16, R > 8): wgmma on the transposed product
//     out^T = W^T x^T. The converted weight is the register A operand (two
//     warpgroups of 64 output columns a block, each lane converting 8
//     weights a 16-value step while up to three earlier products run); x^T
//     is B, read by wgmma from the 128-byte swizzle in shared memory. N,
//     the tile of x's rows, follows R (16, 32, 64, 80, 128 or 256), so R =
//     72 runs as one tile of 80 and each weight is read and converted once
//     per up to 256 rows of x. A cp.async ring of 4 to 8 stages (what 112 KB
//     hold, two blocks an SM; 224 KB at N = 256) brings the weight and x
//     tiles stages - 2 ahead of the math. Where the output tiles do not
//     fill the card, the contraction is split over a cluster, summed as in
//     decode; unsplit, each lane scales and stores its own sums.
//   * Both tensor-core kernels are programmatic launches: the weight and
//     its scales, which no kernel of the forward writes, start streaming
//     before the kernel ahead in the stream has finished; x is read after
//     `griddepcontrol.wait`. The epilogue scales the f32 sum (the scales
//     staged with the first copies) and writes x's type (io) or f32 (vd).
//   * f32 x (the tests' small f32 reference; not on a served path): the
//     scalar GEMV in f32 FMA (TF32 would miss the 1e-5 tolerance): io, a
//     block of 256 columns, a lane 8 adjacent columns, split over a cluster
//     as decode is; vd, a warp 4 table rows; blocks of 8 rows of x over
//     grid.z.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using hopper::cp_async16;

enum Layout { kIO = 0, kVD = 1 };
enum Route { kRouteGemv = 0, kRouteDecode = 1, kRouteWgmma = 2 };

constexpr int kMaxRows = 8;    // rows of x a GEMV or decode block covers
constexpr int kThreads = 256;  // every block: eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kKStep = 64;     // a split's contraction is a multiple of this
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block may take
constexpr uint32_t kBias = 0x80808080u;  // int8 q -> byte q + 128

// Element j of a word of four int8 values, already XORed with kBias, as an
// exact f32: 2**23 + (q + 128), minus 2**23 + 128.
__device__ __forceinline__ float i8f(uint32_t wb, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(wb, 0x4B000000u, 0x7440 | j)), 8388736.f);
}

// (a & b) | c in one instruction (the compiler splits two constant
// operands into two).
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Bytes 0 and 2 of t (two int8 values) as an exact bf16x2, byte 0 in the
// low half: bf16 128 + (q & 127) plus -128, or -256 when the sign bit is
// set.
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t t) {
  const uint32_t m = and_or(t, 0x007F007Fu, 0x43004300u);
  const uint32_t b = and_or(t, 0x00800080u, 0xC300C300u);
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(m), "r"(0x3F803F80u), "r"(b));
  return r;
}

// Four adjacent outputs in one store.
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(hopper::pack_bf16(a, b), hopper::pack_bf16(c, d));
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The cluster epilogue of the tensor-core routes: `P` (pitch floats a row,
// `tr` x `tc` f32, tc a multiple of 4) holds this block's partial tile in
// shared memory, `sc` the tile's tc scales (staged with the first copies,
// so no read of device memory waits here). After a cluster barrier, rank q
// of S blocks adds every S-th group of four columns over the ranks in rank
// order (the ranks' reads issued together), scales it and writes rows < nr
// of `out` (already at the tile's first row), columns c0 + c < n_out; a
// second barrier keeps every tile alive until all reads are done. A launch
// of one block a cluster adds nothing.
template <typename OutT>
__device__ __forceinline__ void cluster_sum_store(float* P, int pitch, int tr, int tc,
                                                  OutT* out, const float* sc, int nr,
                                                  int n_out, int c0) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int q4 = tc / 4;
  for (int e = rank * kThreads + (int)threadIdx.x; e < tr * q4; e += splits * kThreads) {
    const int r = e / q4, c = (e % q4) * 4;
    if (r < nr && c0 + c < n_out) {
      float4 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q < splits)
          v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(P, q) + r * pitch + c);
      }
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q < splits) sum.x += v[q].x, sum.y += v[q].y, sum.z += v[q].z, sum.w += v[q].w;
      }
      const float4 f = *reinterpret_cast<const float4*>(sc + c);
      store4(out + (long long)r * n_out + c0 + c, sum.x * f.x, sum.y * f.y, sum.z * f.z,
             sum.w * f.w);
    }
  }
  cluster.sync();
}

// ------------------------------------------------------- decode (bf16)

constexpr int kDecCols[] = {128, 64, 32, 16};  // io output columns a block (C = BN / 16)
constexpr int kDecVdCols = 64;                  // table rows a vd block (C = 4)
constexpr int kDecStages = 6;
constexpr int kDecStageBytes = 8192;            // int8 weight bytes a stage
constexpr int kDecSliceK = kDecStageBytes / 128;  // contraction a warp takes of each stage
constexpr int kDecCopies = kDecStageBytes / 16 / kThreads;  // 16-byte copies a thread a stage

// The stage geometry of a block of BN = 16 C outputs of layout L: BK
// contraction values of them a stage. io: BK = 512 / C rows of BN bytes,
// padded by 16 where BN is 64 or 128 (rows 1, 2 and 3 after a row then
// start in other banks); vd: 64 table rows of BK = 128 bytes, 16-byte
// chunk (v, c) at v BK / 16 + (c ^ 2 (v % 4)).
template <int L, int C> struct Dec {
  static constexpr int BN = 16 * C;
  static constexpr int BK = kDecStageBytes / BN;
  static constexpr int kPitch = L == kVD ? BK : BN <= 32 ? BN : BN + 16;  // bytes a row
  static constexpr int kStage = L == kIO ? BK * kPitch : kDecStageBytes;
};

// x staged once: `rows` rows of the split's contraction, padded to a
// multiple of kDecSliceK with zeros, plus 32 values of row pitch (a lane's
// 16-byte reads of rows gid and gid + 1 then fall in other banks); then the
// block's scales (at most 128).
__host__ __device__ inline int dec_x_pitch(int k_len) {
  return (k_len + kDecSliceK - 1) / kDecSliceK * kDecSliceK + 32;
}
template <int L, int C> int dec_smem_bytes(int rows, int k_len) {
  return kDecStages * Dec<L, C>::kStage + rows * dec_x_pitch(k_len) * 2 + 128 * 4;
}

// Warp w takes the outputs 16 (w % C) .. + 15 and kDecSliceK contraction
// values from kDecSliceK (w / C) of every stage, 32 a step. In a step lane
// tig holds 8 contraction values: io rows tig + 4 j (j < 8), so that for
// each j the four tig read four adjacent padded rows at an offset known at
// compile time, with x staged permuted to match (the values of rows tig +
// 4 j at 8 tig + j); vd values 8 tig + j, one 8-byte read a table row, x
// as it is. The first m16n8k16 takes j = 0, 1 (k slots 2 tig, + 1) and 2,
// 3 (slots 2 tig + 8, + 9), the second j = 4 .. 7, in A and in B alike.
template <int L, int C, typename OutT>
__global__ void __launch_bounds__(kThreads, L == kIO ? 3 : 2)
int8_decode_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ s, OutT* __restrict__ out, int rows, int n_in,
                   int n_out, long long ldx, int k_split) {
  using G = Dec<L, C>;
  constexpr int BN = G::BN, BK = G::BK, RP = G::kPitch;
  static_assert(L == kIO || C == kDecVdCols / 16, "a vd block is 64 table rows");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int cs = warp % C, kw = (warp / C) * kDecSliceK;
  const int c0 = blockIdx.x * BN;
  const int split = (int)cg::this_cluster().block_rank();
  const int k_beg = split * k_split, k_len = min(k_split, n_in - k_beg);
  const int n_tiles = (k_len + BK - 1) / BK;
  const int xp = dec_x_pitch(k_len);
  bf16* xs = reinterpret_cast<bf16*>(smem + kDecStages * G::kStage);
  float* ss = reinterpret_cast<float*>(xs + rows * xp);

  // Weight tile t into its stage, 16-byte chunks, zeros past the split's
  // contraction or the last output. A thread's copies are chunks tid + 256
  // j of every stage: their source moves by a tile's rows (io) or values
  // (vd) from tile to tile, the destination and the bound stay; tiles go in
  // order.
  const int8_t* src[kDecCopies];
  int dst[kDecCopies], lim[kDecCopies];
#pragma unroll
  for (int j = 0; j < kDecCopies; ++j) {
    const int i = tid + kThreads * j;
    if (L == kIO) {
      const int r = i / C, c = i % C;
      src[j] = w + (long long)(k_beg + r) * n_out + c0 + 16 * c;
      dst[j] = r * RP + 16 * c;
      lim[j] = c0 + 16 * c < n_out ? k_len - r : 0;  // copies while k0 < lim
    } else {
      const int v = i / (BK / 16), c = i % (BK / 16);
      src[j] = w + (long long)(c0 + v) * n_in + k_beg + 16 * c;
      dst[j] = (v * (BK / 16) + (c ^ ((v & 3) << 1))) * 16;
      lim[j] = c0 + v < n_out ? k_len - 16 * c : 0;
    }
  }
  const long long step = L == kIO ? (long long)BK * n_out : BK;
  int slot = 0;  // the stage of the next tile issued
  auto issue = [&](int t) {
    unsigned char* st = smem + slot * G::kStage;
    slot = slot + 1 == kDecStages ? 0 : slot + 1;
#pragma unroll
    for (int j = 0; j < kDecCopies; ++j) {
      const bool ok = t * BK < lim[j];
      cp_async16(st + dst[j], ok ? src[j] : w, ok);
      src[j] += step;
    }
  };
  // The scales and the first five stages, read before the kernel ahead in
  // the stream has finished (a programmatic launch); then x (8 values a
  // chunk, zeros past k_len), which that kernel may write, once: vd by
  // cp.async, io by plain loads (they wait for x alone, not for the stages
  // ahead of them).
  if (tid < BN / 4) cp_async16(ss + 4 * tid, s + c0 + 4 * tid, c0 + 4 * tid < n_out);
#pragma unroll
  for (int t = 0; t < kDecStages - 1; ++t) {
    if (t < n_tiles) issue(t);
    hopper::cp_async_commit();
  }
  hopper::grid_dependency_wait();
  const int xc = (xp - 32) / 8;
  if (L == kVD) {
    for (int i = tid; i < rows * xc; i += kThreads) {
      const int r = i / xc, k = (i % xc) * 8;
      const bool ok = k < k_len;
      cp_async16(xs + r * xp + k, ok ? x + r * ldx + k_beg + k : x, ok);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
  } else {
    // io: permuted within each 32 values as it is staged, value 8 m + i to
    // 8 (i % 4) + 2 m + i / 4 (the pair i, i + 4 one 4-byte store); the
    // loop's first barrier publishes it.
    for (int i = tid; i < rows * xc; i += kThreads) {
      const int r = i / xc, k = (i % xc) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < k_len) v = *reinterpret_cast<const uint4*>(x + r * ldx + k_beg + k);
      uint32_t* d = reinterpret_cast<uint32_t*>(xs + r * xp + (k & ~31) + (k & 31) / 4);
      d[0] = __byte_perm(v.x, v.z, 0x5410);
      d[4] = __byte_perm(v.x, v.z, 0x7632);
      d[8] = __byte_perm(v.y, v.w, 0x5410);
      d[12] = __byte_perm(v.y, v.w, 0x7632);
    }
  }

  // acc: A row gid is output 2 gid (io) or gid (vd) of the warp's 16, row
  // gid + 8 output 2 gid + 1 or gid + 8; column n is x row n.
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const bool x_row = gid < rows;
  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait<kDecStages - 2>();
    // Tile t landed for every thread (and x is in place), and every warp is
    // done with tile t - 1, whose stage takes tile t + 5.
    __syncthreads();
    if (t + kDecStages - 1 < n_tiles) issue(t + kDecStages - 1);
    hopper::cp_async_commit();
    const unsigned char* st = smem + (t % kDecStages) * G::kStage;
    if (t * BK + kw >= k_len) continue;  // past the split's end: zeros only
#pragma unroll
    for (int h = 0; h < kDecSliceK / 32; ++h) {
      const int kr = kw + 32 * h;
      uint4 xv = make_uint4(0u, 0u, 0u, 0u);
      if (x_row) xv = *reinterpret_cast<const uint4*>(xs + gid * xp + t * BK + kr + 8 * tig);
      uint32_t a[2][4];
      if (L == kIO) {
        // Rows kr + tig + 4 j, columns 2 gid and 2 gid + 1 of the warp's 16.
        const unsigned char* wp = st + (kr + tig) * RP + cs * 16 + 2 * gid;
        uint32_t hw[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) hw[j] = *reinterpret_cast<const uint16_t*>(wp + 4 * j * RP);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t lo = __byte_perm(hw[4 * p], hw[4 * p + 1], 0x5410);
          const uint32_t hi = __byte_perm(hw[4 * p + 2], hw[4 * p + 3], 0x5410);
          a[p][0] = i8x2_bf16(lo);
          a[p][1] = i8x2_bf16(lo >> 8);
          a[p][2] = i8x2_bf16(hi);
          a[p][3] = i8x2_bf16(hi >> 8);
        }
      } else {
        const int v = cs * 16 + gid, c = (kr + 8 * tig) / 16, off = (8 * tig) % 16;
        const int sw = c ^ ((v & 3) << 1);  // rows v and v + 8 swizzle alike
        const uint2 wa = *reinterpret_cast<const uint2*>(st + (v * (BK / 16) + sw) * 16 + off);
        const uint2 wb =
            *reinterpret_cast<const uint2*>(st + ((v + 8) * (BK / 16) + sw) * 16 + off);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t ta = __byte_perm(p ? wa.y : wa.x, 0u, 0x3120);
          const uint32_t tb = __byte_perm(p ? wb.y : wb.x, 0u, 0x3120);
          a[p][0] = i8x2_bf16(ta);
          a[p][1] = i8x2_bf16(tb);
          a[p][2] = i8x2_bf16(ta >> 8);
          a[p][3] = i8x2_bf16(tb >> 8);
        }
      }
      hopper::mma_bf16(acc, a[0], xv.x, xv.y);
      hopper::mma_bf16(acc, a[1], xv.z, xv.w);
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial tiles reuse it

  // The warps' tiles red[warp][x row][16 outputs], added over the
  // contraction slices in slice order into P [8][BN].
  float* red = reinterpret_cast<float*>(smem);
  float* P = red + kWarps * kMaxRows * 16;
  {
    const int m0 = L == kIO ? 2 * gid : gid, m1 = L == kIO ? 2 * gid + 1 : gid + 8;
    float* rw = red + warp * kMaxRows * 16;
    rw[(2 * tig) * 16 + m0] = acc[0];
    rw[(2 * tig + 1) * 16 + m0] = acc[1];
    rw[(2 * tig) * 16 + m1] = acc[2];
    rw[(2 * tig + 1) * 16 + m1] = acc[3];
  }
  __syncthreads();
  for (int e = tid; e < kMaxRows * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps / C; ++k)
      sum += red[((k * C + c / 16) * kMaxRows + r) * 16 + c % 16];
    P[r * BN + c] = sum;
  }
  cluster_sum_store<OutT>(P, BN, kMaxRows, BN, out, ss, rows, n_out, c0);
}

// ------------------------------------------------ verify, prefill (bf16)

constexpr int kWgRows[] = {16, 32, 64, 80, 128, 256};  // N: x rows a block
constexpr int kWgBN = 128;                  // output columns a block: two warpgroups of 64
constexpr int kWgBK = 64;                   // contraction a stage
constexpr int kWgRing = 112 * 1024;         // ring bytes of a block, two blocks an SM
constexpr int kWgRowIO = kWgBN + 16;        // bytes a staged io weight row
constexpr int kWgRowVD = kWgBK + 16;        // bytes a staged vd table row
constexpr int kWgPitchP = kWgBN + 4;        // f32 a row of the partial tile

template <int L> __host__ __device__ constexpr int wg_w_bytes() {
  return L == kIO ? kWgBK * kWgRowIO : kWgBN * kWgRowVD;
}
// A stage: the x tile (N rows of 64 values, 128 bytes, in the 128-byte
// swizzle), then the weight tile; 1024-byte aligned.
template <int L, int N> __host__ __device__ constexpr int wg_stage_bytes() {
  return (N * 128 + wg_w_bytes<L>() + 1023) / 1024 * 1024;
}
// Stages: as many as fit the ring's bytes (twice them at N = 256, one
// block an SM), 4 to 8; the copies run stages - 2 tiles ahead of the math.
template <int L, int N> __host__ __device__ constexpr int wg_stages() {
  return (N <= 128 ? 1 : 2) * kWgRing / wg_stage_bytes<L, N>() < 4 ? 4
       : (N <= 128 ? 1 : 2) * kWgRing / wg_stage_bytes<L, N>() > 8 ? 8
       : (N <= 128 ? 1 : 2) * kWgRing / wg_stage_bytes<L, N>();
}
// The ring (then the partial tile), the scales, 1024 bytes to align.
template <int L, int N> __host__ __device__ constexpr int wg_smem_bytes() {
  return (wg_stages<L, N>() * wg_stage_bytes<L, N>() > N * kWgPitchP * 4
              ? wg_stages<L, N>() * wg_stage_bytes<L, N>() : N * kWgPitchP * 4) +
         kWgBN * 4 + 1024;
}

// Block (column tile, split, row tile). Warp w = 4 g + l of warpgroup g
// holds A rows 16 l .. + 15 of the group's 64 outputs: row gid is output 64
// g + 16 l + 2 gid (io) or + gid (vd), row gid + 8 output + 2 gid + 1 or +
// gid + 8. io stage rows are padded to 144 bytes and vd rows to 80, so a
// warp's 2-byte reads hit distinct banks.
template <int L, int N, typename OutT>
__global__ void __launch_bounds__(kThreads, N <= 128 ? 2 : 1)
int8_wgmma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ s, OutT* __restrict__ out, int rows, int n_in,
                  int n_out, long long ldx, int k_split) {
  constexpr int SB = wg_stage_bytes<L, N>();
  constexpr int S = wg_stages<L, N>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (1024 - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) % 1024) % 1024;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wo = (warp / 4) * 64 + (warp % 4) * 16;  // the warp's 16 outputs
  const int c0 = blockIdx.x * kWgBN, r0 = blockIdx.z * N;
  const int nr = min(N, rows - r0);
  const int split = (int)cg::this_cluster().block_rank();
  const int k_beg = split * k_split, k_len = min(k_split, n_in - k_beg);
  const int n_tiles = (k_len + kWgBK - 1) / kWgBK;

  // Tile t's copies into its stage: the x tile (N rows x 8 chunks, up to
  // XC a thread; rows past R zero), and the weight tile (2 chunks a
  // thread). A copy's source moves by 64 contraction values from tile to
  // tile, its destination and bound stay; each kind goes through the tiles
  // in order.
  constexpr int XC = (N * 8 + kThreads - 1) / kThreads;
  const bf16* xsrc[XC];
  int xdst[XC], xlim[XC];
#pragma unroll
  for (int m = 0; m < XC; ++m) {
    const int i = tid + kThreads * m, r = i / 8, c = i % 8;
    xsrc[m] = x + (long long)(r0 + r) * ldx + k_beg + 8 * c;
    xdst[m] = i < N * 8 ? r * 128 + ((c ^ (r & 7)) * 16) : -1;  // -1: no chunk
    xlim[m] = r < nr ? k_len - 8 * c : 0;  // copies while k0 < xlim
  }
  const int8_t* wsrc[2];
  int wdst[2], wlim[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + kThreads * j;
    if (L == kIO) {
      const int r = i / 8, c = i % 8;
      wsrc[j] = w + (long long)(k_beg + r) * n_out + c0 + 16 * c;
      wdst[j] = N * 128 + r * kWgRowIO + 16 * c;
      wlim[j] = c0 + 16 * c < n_out ? k_len - r : 0;
    } else {
      const int v = i / 4, c = i % 4;
      wsrc[j] = w + (long long)(c0 + v) * n_in + k_beg + 16 * c;
      wdst[j] = N * 128 + v * kWgRowVD + 16 * c;
      wlim[j] = c0 + v < n_out ? k_len - 16 * c : 0;
    }
  }
  const long long wstep = L == kIO ? (long long)kWgBK * n_out : kWgBK;
  int xslot = 0, wslot = 0;
  auto issue_x = [&](int t) {
    unsigned char* st = smem + xslot * SB;
    xslot = xslot + 1 == S ? 0 : xslot + 1;
#pragma unroll
    for (int m = 0; m < XC; ++m) {
      const bool ok = t * kWgBK < xlim[m];
      if (xdst[m] >= 0) cp_async16(st + xdst[m], ok ? xsrc[m] : x, ok);
      xsrc[m] += kWgBK;
    }
  };
  auto issue_w = [&](int t) {
    unsigned char* st = smem + wslot * SB;
    wslot = wslot + 1 == S ? 0 : wslot + 1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = t * kWgBK < wlim[j];
      cp_async16(st + wdst[j], ok ? wsrc[j] : w, ok);
      wsrc[j] += wstep;
    }
  };

  // acc: this warpgroup's out^T tile, 64 outputs x N rows of x. The first
  // product overwrites it (a zeroing store would serialize the wgmmas).
  float acc[N / 2];
  // A of the four 16-value steps of a tile, each in registers of its own.
  uint32_t a[4][4] = {};
  // The scales and the weight tiles of the first S - 2 stages, read before
  // the kernel ahead in the stream has finished (a programmatic launch);
  // then their x tiles, which that kernel may write, a copy group a tile.
  float* ss = reinterpret_cast<float*>(smem + (wg_smem_bytes<L, N>() - 1024 - kWgBN * 4));
  if (tid < kWgBN / 4) cp_async16(ss + 4 * tid, s + c0 + 4 * tid, c0 + 4 * tid < n_out);
#pragma unroll
  for (int t = 0; t < S - 2; ++t) {
    if (t < n_tiles) issue_w(t);
  }
  hopper::grid_dependency_wait();
#pragma unroll
  for (int t = 0; t < S - 2; ++t) {
    if (t < n_tiles) issue_x(t);
    hopper::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    hopper::cp_async_wait<S - 3>();  // this thread's copies of tile it
    hopper::fence_async_shared();
    // Every thread's copies of tile it have landed, and every warpgroup's
    // products of tile it - 2 are done (each waits for all but its last
    // three groups, all of tile it - 1), so its stage takes the copies of
    // tile it + S - 2.
    __syncthreads();
    if (it + S - 2 < n_tiles) {
      issue_x(it + S - 2);
      issue_w(it + S - 2);
    }
    hopper::cp_async_commit();
    const unsigned char* st = smem + (it % S) * SB;
    const uint64_t desc = hopper::desc_sw128(st);
    const unsigned char* W = st + N * 128;
#pragma unroll
    for (int ks = 0; ks < kWgBK / 16; ++ks) {
      // A of this 16-value step, converted while the previous steps'
      // products run. Up to four products are in flight, each reading the
      // A registers of its step: a step's registers are written again four
      // steps later, after the wait that retires the product reading them
      // (the empty asm after the wait keeps the compiler from reusing them
      // sooner).
      uint32_t* ak = a[ks];
      if (L == kIO) {
        // Rows 16 ks + 2 tig, + 1 (a0, a1) and + 8, + 9 (a2, a3), the
        // lane's two columns' bytes each.
        const unsigned char* p = W + (ks * 16 + 2 * tig) * kWgRowIO + wo + 2 * gid;
        const uint32_t h0 = *reinterpret_cast<const uint16_t*>(p);
        const uint32_t h1 = *reinterpret_cast<const uint16_t*>(p + kWgRowIO);
        const uint32_t h8 = *reinterpret_cast<const uint16_t*>(p + 8 * kWgRowIO);
        const uint32_t h9 = *reinterpret_cast<const uint16_t*>(p + 9 * kWgRowIO);
        const uint32_t lo = __byte_perm(h0, h1, 0x5410), hi = __byte_perm(h8, h9, 0x5410);
        ak[0] = i8x2_bf16(lo);
        ak[1] = i8x2_bf16(lo >> 8);
        ak[2] = i8x2_bf16(hi);
        ak[3] = i8x2_bf16(hi >> 8);
      } else {
        // Table rows gid and gid + 8 of the warp's 16, values 16 ks + 2 tig,
        // + 1 and + 8, + 9.
        const unsigned char* p = W + (wo + gid) * kWgRowVD + ks * 16 + 2 * tig;
        const uint32_t tg = __byte_perm(*reinterpret_cast<const uint16_t*>(p),
                                        *reinterpret_cast<const uint16_t*>(p + 8), 0x5140);
        const uint32_t th = __byte_perm(*reinterpret_cast<const uint16_t*>(p + 8 * kWgRowVD),
                                        *reinterpret_cast<const uint16_t*>(p + 8 * kWgRowVD + 8),
                                        0x5140);
        ak[0] = i8x2_bf16(tg);
        ak[1] = i8x2_bf16(th);
        ak[2] = i8x2_bf16(tg >> 8);
        ak[3] = i8x2_bf16(th >> 8);
      }
      hopper::wgmma_fence();
      hopper::wgmma_rs<N>(acc, ak, desc + 2 * ks, it > 0 || ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<3>();
      const uint32_t* done = a[(ks + 1) % 4];  // the step four before the next
      asm volatile("" :: "r"(done[0]), "r"(done[1]), "r"(done[2]), "r"(done[3]));
    }
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) hopper::fence_operand(acc[i]);
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partial tile reuses it

  // acc[4j + e]: output row gid + 8 (e / 2) of the warp's A, x row 8j + 2
  // tig + e % 2. Unsplit, the lane scales and stores its sums (io: the
  // adjacent outputs m0, m1 one 4-byte store); split, they go to P [N]
  // [kWgBN] (pitch kWgPitchP) for the cluster's sum.
  const int m0 = wo + (L == kIO ? 2 * gid : gid), m1 = wo + (L == kIO ? 2 * gid + 1 : gid + 8);
  if (cg::this_cluster().num_blocks() == 1) {
    const float s0 = ss[m0], s1 = ss[m1];
    OutT* o = out + (long long)r0 * n_out + c0;
    if (c0 + m0 < n_out) {  // m0 and m1 in the same 16 outputs: both in or out
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 8 * j + 2 * tig + h;
          if (n < nr) {
            if constexpr (L == kIO) {
              *reinterpret_cast<uint32_t*>(o + (long long)n * n_out + m0) =
                  hopper::pack_bf16(acc[4 * j + h] * s0, acc[4 * j + 2 + h] * s1);
            } else {
              o[(long long)n * n_out + m0] = acc[4 * j + h] * s0;
              o[(long long)n * n_out + m1] = acc[4 * j + 2 + h] * s1;
            }
          }
        }
      }
    }
    return;
  }
  float* P = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      P[(8 * j + 2 * tig + (e & 1)) * kWgPitchP + (e < 2 ? m0 : m1)] = acc[4 * j + e];
  }
  cluster_sum_store<OutT>(P, kWgPitchP, N, kWgBN, out + (long long)r0 * n_out, ss, nr, n_out,
                          c0);
}

// ------------------------------------------------------------ GEMV (f32)

constexpr int kGemvBN = 256;  // output columns of an io block: 8 a lane
constexpr int kGemvKC = 256;  // contraction rows of x staged a pass

// acc[r][j] += x[r] * q[j] for the 8 columns of one contraction row: `wv`
// holds their int8 values, `xk` the row's x values of the block's rows.
template <int RB>
__device__ __forceinline__ void fma_row(float (&acc)[RB][8], uint2 wv, const float* xk) {
  const uint32_t lo = wv.x ^ kBias, hi = wv.y ^ kBias;
  float q[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    q[j] = i8f(lo, j);
    q[4 + j] = i8f(hi, j);
  }
  float xr[kMaxRows];
  const float4 xa = *reinterpret_cast<const float4*>(xk);
  xr[0] = xa.x, xr[1] = xa.y, xr[2] = xa.z, xr[3] = xa.w;
  if (RB > 4) {
    const float4 xb = *reinterpret_cast<const float4*>(xk + 4);
    xr[4] = xb.x, xr[5] = xb.y, xr[6] = xb.z, xr[7] = xb.w;
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(xr[r], q[j], acc[r][j]);
  }
}

template <int RB>
__global__ void __launch_bounds__(kThreads)
int8_gemv_io_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ s, float* __restrict__ out, int rows, int n_in,
                    int n_out, long long ldx, int k_split) {
  __shared__ __align__(16) float xs[kGemvKC][kMaxRows];
  __shared__ __align__(16) float red[kWarps][kGemvBN];
  __shared__ __align__(16) float P[kMaxRows * kGemvBN];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * kGemvBN, col = c0 + lane * 8;
  const int r0 = blockIdx.z * kMaxRows, nr = min(RB, rows - r0);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int k_beg = min(split * k_split, n_in), k_end = min(k_beg + k_split, n_in);
  const bool col_ok = col < n_out;  // n_out % 16 == 0: 8 columns in or out

  float acc[RB][8];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  }
  for (int p0 = k_beg; p0 < k_end; p0 += kGemvKC) {
    const int n = min(kGemvKC, k_end - p0);
    __syncthreads();  // the previous pass's readers are done
    for (int i = tid; i < kGemvKC * kMaxRows; i += kThreads) {
      const int k = i % kGemvKC, r = i / kGemvKC;
      xs[k][r] = (r < nr && k < n) ? x[(long long)(r0 + r) * ldx + p0 + k] : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    const int8_t* wp = w + (long long)p0 * n_out + col;
    int k = warp;
    for (; k + 3 * kWarps < n; k += 4 * kWarps) {
      uint2 wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wv[u] = *reinterpret_cast<const uint2*>(wp + (long long)(k + u * kWarps) * n_out);
#pragma unroll
      for (int u = 0; u < 4; ++u) fma_row<RB>(acc, wv[u], xs[k + u * kWarps]);
    }
    for (; k < n; k += kWarps)
      fma_row<RB>(acc, *reinterpret_cast<const uint2*>(wp + (long long)k * n_out), xs[k]);
  }

  // The warps' partial sums of each row, added in warp order, into P.
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(&red[warp][lane * 8]);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    __syncthreads();
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sum += red[i][tid];
    P[r * kGemvBN + tid] = sum;
  }

  // The cluster's partial tiles, added in rank order; rank q writes every
  // splits-th element of the tile, scaled.
  cluster.sync();
  const int splits = (int)cluster.num_blocks();
  for (int e = split * kThreads + tid; e < RB * kGemvBN; e += splits * kThreads) {
    const int r = e / kGemvBN, c = c0 + e % kGemvBN;
    if (r < nr && c < n_out) {
      float sum = 0.f;
      for (int q = 0; q < splits; ++q) sum += cluster.map_shared_rank(P, q)[e];
      out[(long long)(r0 + r) * n_out + c] = sum * s[c];
    }
  }
  cluster.sync();  // every tile stays alive until all reads are done
}

constexpr int kVdRowsW = 4;                  // table rows a warp
constexpr int kVdBV = kWarps * kVdRowsW;     // table rows a block
constexpr int kVdDC = 512;                   // hidden values of x staged a pass

template <int RB>
__global__ void __launch_bounds__(kThreads)
int8_gemv_vd_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ s, float* __restrict__ out, int rows, int n_in,
                    int n_out, long long ldx) {
  __shared__ __align__(16) float xs[kMaxRows][kVdDC];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int v0 = blockIdx.x * kVdBV + warp * kVdRowsW;
  const int r0 = blockIdx.z * kMaxRows, nr = min(RB, rows - r0);

  float acc[kVdRowsW][RB];
#pragma unroll
  for (int v = 0; v < kVdRowsW; ++v) {
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[v][r] = 0.f;
  }
  for (int d0 = 0; d0 < n_in; d0 += kVdDC) {
    const int n = min(kVdDC, n_in - d0);  // a multiple of 16
    __syncthreads();
    for (int i = tid; i < RB * kVdDC; i += kThreads) {
      const int r = i / kVdDC, d = i % kVdDC;
      xs[r][d] = (r < nr && d < n) ? x[(long long)(r0 + r) * ldx + d0 + d] : 0.f;
    }
    __syncthreads();
    // Lane l reads hidden values 128 q + 4 l .. + 3 of each of its rows.
    uint32_t wv[kVdDC / 128][kVdRowsW];
#pragma unroll
    for (int q = 0; q < kVdDC / 128; ++q) {
      const int d = q * 128 + lane * 4;
#pragma unroll
      for (int v = 0; v < kVdRowsW; ++v) {
        const bool ok = d < n && v0 + v < n_out;
        wv[q][v] = ok ? *reinterpret_cast<const uint32_t*>(
                            w + (long long)(v0 + v) * n_in + d0 + d) : 0u;
      }
    }
#pragma unroll
    for (int q = 0; q < kVdDC / 128; ++q) {
      const int d = q * 128 + lane * 4;
      float4 xr[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) xr[r] = *reinterpret_cast<const float4*>(&xs[r][d]);
#pragma unroll
      for (int v = 0; v < kVdRowsW; ++v) {
        const uint32_t wb = wv[q][v] ^ kBias;
        const float q0 = i8f(wb, 0), q1 = i8f(wb, 1), q2 = i8f(wb, 2), q3 = i8f(wb, 3);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          acc[v][r] = fmaf(xr[r].x, q0, acc[v][r]);
          acc[v][r] = fmaf(xr[r].y, q1, acc[v][r]);
          acc[v][r] = fmaf(xr[r].z, q2, acc[v][r]);
          acc[v][r] = fmaf(xr[r].w, q3, acc[v][r]);
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < kVdRowsW; ++v) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float a = acc[v][r];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) a += __shfl_xor_sync(0xFFFFFFFFu, a, m);
      if (lane == v * RB + r && r < nr && v0 + v < n_out)
        out[(long long)(r0 + r) * n_out + v0 + v] = a * s[v0 + v];
    }
  }
}

// ------------------------------------------------------------- launches

// Opt a kernel into the most dynamic shared memory a block may take, once
// (`done` is the flag of its launch function's instantiation).
int opt_in(const void* kernel, bool* done) {
  if (*done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  *done = true;
  return 0;
}

template <int L, int C, typename OutT>
int launch_decode(const bf16* x, const int8_t* w, const float* s, void* out, int rows,
                  int n_in, int n_out, long long ldx, int splits, int k_split, cudaStream_t st) {
  const auto kernel = int8_decode_kernel<L, C, OutT>;
  const int smem = dec_smem_bytes<L, C>(rows, k_split < n_in ? k_split : n_in);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool done = false;
  if (int err = opt_in((const void*)kernel, &done)) return err;
  const dim3 grid((n_out + 16 * C - 1) / (16 * C), splits);
  return hopper::launch_cluster_pdl(kernel, grid, kThreads, smem, splits, st, x, w, s,
                                    static_cast<OutT*>(out), rows, n_in, n_out, ldx, k_split);
}

int decode(int layout, int tile, const bf16* x, const int8_t* w, const float* s, void* out,
           int rows, int n_in, int n_out, long long ldx, int splits, int k_split,
           cudaStream_t st) {
  if (layout == kVD) {
    if (tile != kDecVdCols || splits != 1) return (int)cudaErrorInvalidValue;
    return launch_decode<kVD, kDecVdCols / 16, float>(x, w, s, out, rows, n_in, n_out, ldx, 1,
                                                      k_split, st);
  }
  switch (tile) {
    case kDecCols[0]: return launch_decode<kIO, kDecCols[0] / 16, bf16>(x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case kDecCols[1]: return launch_decode<kIO, kDecCols[1] / 16, bf16>(x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case kDecCols[2]: return launch_decode<kIO, kDecCols[2] / 16, bf16>(x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case kDecCols[3]: return launch_decode<kIO, kDecCols[3] / 16, bf16>(x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int L, int N, typename OutT>
int launch_wgmma(const bf16* x, const int8_t* w, const float* s, void* out, int rows, int n_in,
                 int n_out, long long ldx, int splits, int k_split, cudaStream_t st) {
  const auto kernel = int8_wgmma_kernel<L, N, OutT>;
  static_assert(wg_smem_bytes<L, N>() <= kMaxSmem, "the ring fits a block");
  static bool done = false;
  if (int err = opt_in((const void*)kernel, &done)) return err;
  const dim3 grid((n_out + kWgBN - 1) / kWgBN, splits, (rows + N - 1) / N);
  return hopper::launch_cluster_pdl(kernel, grid, kThreads, wg_smem_bytes<L, N>(), splits, st,
                                    x, w, s, static_cast<OutT*>(out), rows, n_in, n_out, ldx,
                                    k_split);
}

template <int L, typename OutT>
int wgmma_rows(int tile, const bf16* x, const int8_t* w, const float* s, void* out, int rows,
               int n_in, int n_out, long long ldx, int splits, int k_split, cudaStream_t st) {
  switch (tile) {
    case kWgRows[0]: return launch_wgmma<L, kWgRows[0], OutT>(x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case kWgRows[1]: return launch_wgmma<L, kWgRows[1], OutT>(x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case kWgRows[2]: return launch_wgmma<L, kWgRows[2], OutT>(x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case kWgRows[3]: return launch_wgmma<L, kWgRows[3], OutT>(x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case kWgRows[4]: return launch_wgmma<L, kWgRows[4], OutT>(x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case kWgRows[5]: return launch_wgmma<L, kWgRows[5], OutT>(x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int RB>
int launch_gemv(int layout, const float* x, const int8_t* w, const float* s, void* out,
                int rows, int n_in, int n_out, long long ldx, int splits, int k_split,
                cudaStream_t st) {
  const int zb = (rows + kMaxRows - 1) / kMaxRows;
  if (layout == kIO) {
    const dim3 grid((n_out + kGemvBN - 1) / kGemvBN, splits, zb);
    return hopper::launch_cluster(int8_gemv_io_kernel<RB>, grid, kThreads, 0, splits,
                                  st, x, w, s, static_cast<float*>(out), rows, n_in, n_out, ldx,
                                  k_split);
  }
  const dim3 grid((n_out + kVdBV - 1) / kVdBV, 1, zb);
  int8_gemv_vd_kernel<RB><<<grid, kThreads, 0, st>>>(
      x, w, s, static_cast<float*>(out), rows, n_in, n_out, ldx);
  return (int)cudaGetLastError();
}

int gemv_rows(int layout, const float* x, const int8_t* w, const float* s, void* out, int rows,
              int n_in, int n_out, long long ldx, int splits, int k_split, cudaStream_t st) {
  switch (rows < kMaxRows ? rows : kMaxRows) {
    case 1: return launch_gemv<1>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 2: return launch_gemv<2>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 3: return launch_gemv<3>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 4: return launch_gemv<4>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 5: return launch_gemv<5>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 6: return launch_gemv<6>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 7: return launch_gemv<7>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    default: return launch_gemv<8>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). x rows are
// `ldx` elements apart; n_in % 16 == 0 and n_out % 16 == 0 (n_out is V for
// the vd layout); `x_f32` says x (and the io output) is f32, else bf16; the
// vd output is f32. `route` 0 is the f32 GEMV, 1 the bf16 decode kernel (R
// <= 8; `tile` its output columns: kDecCols for io, kDecVdCols for vd), 2
// the bf16 wgmma kernel (`tile` its rows of x, one of kWgRows). The
// contraction axis is split over a cluster of `splits` <= 8 blocks (the
// GEMV and decode kernels: io only), each covering `k_split` contraction
// values (a multiple of kKStep for the tensor-core routes when split),
// none empty.
extern "C" int int8_matmul(const void* x, const void* q8, const void* s, void* out, int rows,
                           int n_in, int n_out, long long ldx, int x_f32, int layout,
                           int route, int tile, int splits, int k_split, void* stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  if (n_in <= 0 || n_in % 16 || n_out % 16 || (layout != kIO && layout != kVD) ||
      splits < 1 || splits > 8 || (splits > 1 && layout != kIO && route != kRouteWgmma) ||
      k_split <= 0 ||
      (long long)splits * k_split < n_in || (long long)(splits - 1) * k_split >= n_in ||
      (x_f32 != 0) != (route == kRouteGemv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(q8);
  const float* sc = static_cast<const float*>(s);
  if (route == kRouteGemv)
    return gemv_rows(layout, static_cast<const float*>(x), w, sc, out, rows, n_in, n_out, ldx,
                     splits, k_split, st);
  if (splits > 1 && k_split % kKStep) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  switch (route) {
    case kRouteDecode:
      if (rows > kMaxRows) return (int)cudaErrorInvalidValue;
      return decode(layout, tile, xb, w, sc, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case kRouteWgmma:
      if (layout == kIO)
        return wgmma_rows<kIO, bf16>(tile, xb, w, sc, out, rows, n_in, n_out, ldx, splits,
                                     k_split, st);
      return wgmma_rows<kVD, float>(tile, xb, w, sc, out, rows, n_in, n_out, ldx, splits,
                                    k_split, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
