// int4 weight-only matmul, for Hopper (sm_90a).
//
// Replaces the TPU kernel `int4_matmul` of the JAX package
// (llm_based_apache_spark_optimization_tpu/ops/pallas/int4mm.py): its body
// `_int4_mm_kernel`. Same contract:
//
//   x [R, IN] (bf16 or f32, rows contiguous, row stride ldx elements),
//   q4 [IN/2, OUT] uint8 (byte b holds contraction rows 2b in its low
//   nibble and 2b+1 in its high nibble, value = nibble - 8), s4
//   [IN/group, OUT] f32 (group even, and possibly no power of two: 86 for
//   Llama-2-7B's ffn dim) -> out [R, OUT] in x's type, where
//     out[r, o] = sum_i x[r, i] * T((nib(i, o) - 8) * s4[i / group, o])
//   T(.) rounds the f32 product to x's type (the TPU kernel's
//   `deq(...).astype(x.dtype)`), and the sum runs in f32. Only the order of
//   the f32 sums differs from the plain version.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16):
//   decode (R <= 8): the weight bytes, IN/2 * OUT + IN/group * OUT * 4, read
//     once, over 3.35 TB/s (wd of 7B: 24.6 MB, 7.3 us). In practice the
//     dequantize: at that rate an SM must turn about 28 weights a cycle
//     into bf16 (an f32 multiply and a rounding each), close to what its
//     ALUs issue, so the decode kernel is held by instructions per weight.
//   prefill (R = a chunk of hundreds of rows): 2 * R * IN * OUT FLOPs over
//     989 TFLOP/s (wd at R = 1024: 92 GFLOP, 93 us), which only wgmma
//     reaches (mma.sync gets a part of it); the dequantize, once per weight
//     per 256 rows of x, competes with the products for issue slots.
//
// Design. Three kernels; the Python wrapper picks one by a single rule
// (`int4mm.int4_route`) and passes it as `route`:
//   * Why the layout fits the tensor cores: in mma.sync.m16n8k16 one 32-bit
//     fragment register holds two consecutive contraction rows of one
//     matrix row (A) or column (B). One q4 byte is exactly such a pair (rows
//     2p and 2p+1 of column o), so a byte dequantizes into one bf16x2
//     register with no shuffles: a byte_perm per nibble builds the f32 2**23
//     + n, a subtraction of 2**23 + 8 leaves n - 8 exactly, times the f32
//     scale of that packed row's group, then one cvt.rn.bf16x2.f32. That
//     rounds the f32 product once to bf16, bit for bit the plain version's
//     weight. The scale is looked up per packed row, never per tile: a k16
//     step covers 8 packed rows, and at group 86 (43 packed rows) they
//     straddle groups. Each stage carries a byte table (packed row -> staged
//     scale row), filled when the stage is issued.
//   * Decode (bf16, R <= 8): the operands swapped, the dequantized weight is
//     A (16 output columns x 16 contraction rows) and x^T is B (16 x 8): R
//     <= 8 fills n = 8 with no padding to 16. A block owns 128 columns and
//     streams its share of the packed rows through a 4-stage ring of 16-byte
//     cp.async copies (weight tile, x tile, scale rows), the weight read once
//     from HBM, coalesced, behind the math. Eight warps: four column slices
//     of 32 (lane gid takes 4 adjacent columns, one 32-bit word of a packed
//     row) times two halves of each stage's 64 packed rows; the halves'
//     partial tiles are added in shared memory. Staged rows are padded so a
//     warp's 32-bit reads hit 32 banks. The contraction axis is split over a
//     thread-block cluster of up to 8 blocks (cluster dims (1, splits, 1)):
//     each block leaves its f32 partial tile in shared memory and, after a
//     cluster barrier, the blocks add the tiles through distributed shared
//     memory in cluster-rank order (deterministic) and write the result. One
//     launch; no f32 scratch in device memory. What holds it (measured): its
//     instructions per weight, not its reads.
//   * Prefill (bf16, R > 8): wgmma, with the dequantized weight as the
//     register A operand of the transposed product out^T = W^T x^T. Tiles
//     of 256 rows of x x 128 output columns x 64 contraction rows; two
//     warpgroups of 64 columns, each issuing one m64n256k16 per 16
//     contraction rows. A lane dequantizes 8 weights a step (its two
//     columns' bytes of packed rows ra and rb) straight into A registers
//     (wgmma's A layout is m16n8k16's, warp by warp) while the previous
//     step's product runs: one dequantize serves 256 rows of x, and nothing
//     dequantized touches shared memory. x is the B operand: a 4-stage
//     cp.async ring, two stages ahead of the math, brings each x tile into
//     the 128-byte swizzle that wgmma's K-major descriptor reads, with the
//     packed weight tile (a quarter of a bf16 tile's bytes) and its scale
//     rows. f32 accumulators in registers; the epilogue stages the bf16 tile
//     in shared memory and stores whole rows in 16-byte writes.
//   * f32 (the tests and the small f32 reference): a scalar rows kernel in
//     f32 FMA (TF32 would miss the 1e-5 tolerance), 128 columns a block,
//     eight warps over the packed rows, R > 8 over grid.z in blocks of 8
//     rows; its decode split reduces through the same cluster epilogue.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using hopper::cp_async16;

enum Route { kRouteRows = 0, kRouteDecode = 1, kRoutePrefill = 2 };

constexpr int kBN = 128;      // output columns of a split kernel's block
constexpr int kMaxRows = 8;   // rows of a split kernel's block
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block may take

// (n - 8) as an exact f32 for the nibble at bit `shift` of w.
__device__ __forceinline__ float nib(uint32_t w, int shift) {
  return __fsub_rn(__uint_as_float(0x4B000000u | ((w >> shift) & 15u)), 8388616.f);
}
// The nibbles of a weight word w (byte b: contraction rows 2p, 2p+1 of one
// column), low and high, each in the low bits of its byte.
struct Nibbles {
  uint32_t lo, hi;
  __device__ __forceinline__ explicit Nibbles(uint32_t w)
      : lo(w & 0x0F0F0F0Fu), hi((w >> 4) & 0x0F0F0F0Fu) {}
};
// Byte `b` of the word as the bf16x2 fragment register T(lo * s), T(hi *
// s): one byte_perm puts a nibble n into the mantissa of 2**23 + n, one
// subtraction makes it n - 8 exactly, then the f32 product is rounded once
// to f32 and once to bf16, as the plain version rounds it.
__device__ __forceinline__ uint32_t deq2(const Nibbles& n, int b, float s) {
  const float lo = __fsub_rn(__uint_as_float(__byte_perm(n.lo, 0x4B000000u, 0x7440 | b)),
                             8388616.f);
  const float hi = __fsub_rn(__uint_as_float(__byte_perm(n.hi, 0x4B000000u, 0x7440 | b)),
                             8388616.f);
  return hopper::pack_bf16(__fmul_rn(lo, s), __fmul_rn(hi, s));
}

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float out(float x) { return x; }
};
template <> struct Cvt<bf16> {
  static __device__ __forceinline__ bf16 out(float x) { return __float2bfloat16(x); }
};

// The cluster epilogue of the split kernels: `P` [kMaxRows][kBN] f32 holds
// this block's partial tile in shared memory. After a cluster barrier,
// rank q of S blocks adds every S-th element of the tile over the ranks in
// rank order and writes it (rows < `rows` of `out`, columns c0 + c <
// n_out); a second barrier keeps every tile alive until all reads are done.
template <typename T>
__device__ __forceinline__ void cluster_reduce_store(const float* P, T* out, int rows,
                                                     int n_out, int c0) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int nthreads = blockDim.x;
  for (int e = rank * nthreads + threadIdx.x; e < kMaxRows * kBN; e += splits * nthreads) {
    const int r = e / kBN, c = e % kBN;
    if (r < rows && c0 + c < n_out) {
      float sum = 0.f;
      for (int q = 0; q < splits; ++q) sum += cluster.map_shared_rank(P, q)[e];
      out[(long long)r * n_out + c0 + c] = Cvt<T>::out(sum);
    }
  }
  cluster.sync();
}

// -------------------------------------------------------- decode (bf16)

constexpr int kDecThreads = 256;           // 4 column slices x 2 halves of a stage
constexpr int kDecBK = 64;                 // packed rows per stage
constexpr int kDecStages = 4;
constexpr int kDecRowW = kBN + 32;         // bytes per staged packed row
constexpr int kDecRowX = 2 * kDecBK + 8;   // bf16 per staged x row
constexpr int kDecOffX = kDecBK * kDecRowW;
constexpr int kDecOffS = kDecOffX + kMaxRows * kDecRowX * 2;

// Scale rows a stage of `bk` packed rows can touch with groups of gp
// packed rows: at most (bk - 1) / gp + 2, and never more than bk.
__host__ __device__ inline int scale_slots(int bk, int gp) {
  const int ns = (bk - 1) / gp + 2;
  return ns < bk ? ns : bk;
}
__host__ __device__ inline int dec_stage_bytes(int ns) {
  return (kDecOffS + ns * kBN * 4 + kDecBK + 127) / 128 * 128;
}

__global__ void __launch_bounds__(kDecThreads, 4)
int4_decode_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ q4,
                   const float* __restrict__ s4, bf16* __restrict__ out, int rows,
                   int n_in, int n_out, int group, long long ldx, int kp_split, int ns) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int stage_bytes = dec_stage_bytes(ns);
  const int slot_off = kDecOffS + ns * kBN * 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wc = warp % 4, half = warp / 4;  // 32 columns, half of each stage
  const int c0 = blockIdx.x * kBN;
  const int n_pk = n_in / 2, gp = group / 2, n_groups = n_in / group;
  const int split = (int)cg::this_cluster().block_rank();
  const int p_beg = min(split * kp_split, n_pk), p_end = min(p_beg + kp_split, n_pk);
  const int n_tiles = (p_end - p_beg + kDecBK - 1) / kDecBK;

  // Copies of tile `it` (packed rows p0..p0+63 of the split) into its stage:
  // weight bytes, x (zeros past R or the split), the scale rows of the
  // groups they touch, and the packed row -> scale row table. A thread's
  // share is fixed but for the tile's rows: weight rows tid / 8 and tid / 8
  // + 32, chunk tid % 8 (16 bytes); x row tid / 16 (tid < 128), chunk tid %
  // 16 (8 values); scale rows tid / 32 + 8k (< ns), chunk tid % 32 (4
  // values); the slot of packed row tid (tid < 64).
  const int wr = tid / 8, wch = (tid % 8) * 16;
  const bool w_col = c0 + wch < n_out;
  const uint8_t* w_src = q4 + (long long)(p_beg + wr) * n_out + c0 + wch;
  const int xr = tid / 16, xch = (tid % 16) * 8;
  const bool x_row = tid < 128 && xr < rows;
  const bf16* x_src = x + xr * ldx + 2 * p_beg + xch;
  const int sr = tid / 32, sch = (tid % 32) * 4;
  const bool s_col = c0 + sch < n_out;
  auto issue = [&](int it) {
    unsigned char* st = smem + (it % kDecStages) * stage_bytes;
    const int p0 = p_beg + it * kDecBK, g0 = p0 / gp;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool ok = w_col && p0 + wr + 32 * k < p_end;
      cp_async16(st + (wr + 32 * k) * kDecRowW + wch,
                 ok ? w_src + (long long)(it * kDecBK + 32 * k) * n_out : q4, ok);
    }
    if (tid < 128) {
      const bool ok = x_row && 2 * p0 + xch < 2 * p_end;
      cp_async16(st + kDecOffX + (xr * kDecRowX + xch) * 2, ok ? x_src + 2 * it * kDecBK : x,
                 ok);
    }
    for (int r = sr; r < ns; r += kDecThreads / 32) {
      const bool ok = s_col && g0 + r < n_groups;
      cp_async16(st + kDecOffS + (r * kBN + sch) * 4,
                 ok ? s4 + (long long)(g0 + r) * n_out + c0 + sch : s4, ok);
    }
    if (tid < kDecBK) st[slot_off + tid] = (unsigned char)(min(p0 + tid, p_end - 1) / gp - g0);
  };

  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int it = 0; it < kDecStages - 1; ++it) {
    if (it < n_tiles) issue(it);
    hopper::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    if (it + kDecStages - 1 < n_tiles) issue(it + kDecStages - 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<kDecStages - 1>();
    __syncthreads();
    const unsigned char* st = smem + (it % kDecStages) * stage_bytes;
    const unsigned char* W = st + wc * 32 + gid * 4;
    const bf16* X = reinterpret_cast<const bf16*>(st + kDecOffX) + gid * kDecRowX + 2 * tig;
    const float* S = reinterpret_cast<const float*>(st + kDecOffS) + wc * 32 + gid * 4;
    const unsigned char* slot = st + slot_off;
#pragma unroll
    for (int kk = 0; kk < kDecBK / 16; ++kk) {
      // This warp's half of the stage: k16 steps half * 4 + kk. Packed rows
      // ra (a0, a1) and rb = ra + 4 (a2, a3); A row gid is column 4 gid +
      // 2j of the warp's 32, row gid + 8 column 4 gid + 2j + 1, for the two
      // m16 tiles j.
      const int ks = half * (kDecBK / 16) + kk;
      const int ra = ks * 8 + tig, rb = ra + 4;
      const Nibbles na(*reinterpret_cast<const uint32_t*>(W + ra * kDecRowW));
      const Nibbles nb(*reinterpret_cast<const uint32_t*>(W + rb * kDecRowW));
      const float4 sa = *reinterpret_cast<const float4*>(S + slot[ra] * kBN);
      const float4 sb = *reinterpret_cast<const float4*>(S + slot[rb] * kBN);
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(X + ks * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(X + ks * 16 + 8);
      uint32_t a[4] = {deq2(na, 0, sa.x), deq2(na, 1, sa.y), deq2(nb, 0, sb.x),
                       deq2(nb, 1, sb.y)};
      hopper::mma_bf16(acc[0], a, b0, b1);
      a[0] = deq2(na, 2, sa.z);
      a[1] = deq2(na, 3, sa.w);
      a[2] = deq2(nb, 2, sb.z);
      a[3] = deq2(nb, 3, sb.w);
      hopper::mma_bf16(acc[1], a, b0, b1);
    }
    __syncthreads();  // this stage is free for the copies kDecStages tiles on
  }
  hopper::cp_async_wait<0>();
  __syncthreads();

  // acc[j][e]: column 4 gid + 2j + e / 2 of the warp's 32, x row 2 tig + e % 2.
  // The second half's partial tile goes to Q, the first half adds it into P.
  float* P = reinterpret_cast<float*>(smem);
  float* Q = P + kMaxRows * kBN;
  const int pc = wc * 32 + gid * 4;
  float4* lo = reinterpret_cast<float4*>((half ? Q : P) + (2 * tig) * kBN + pc);
  float4* hi = reinterpret_cast<float4*>((half ? Q : P) + (2 * tig + 1) * kBN + pc);
  if (half) {
    *lo = make_float4(acc[0][0], acc[0][2], acc[1][0], acc[1][2]);
    *hi = make_float4(acc[0][1], acc[0][3], acc[1][1], acc[1][3]);
  }
  __syncthreads();
  if (!half) {
    const float4 ql = *reinterpret_cast<const float4*>(Q + (2 * tig) * kBN + pc);
    const float4 qh = *reinterpret_cast<const float4*>(Q + (2 * tig + 1) * kBN + pc);
    *lo = make_float4(acc[0][0] + ql.x, acc[0][2] + ql.y, acc[1][0] + ql.z, acc[1][2] + ql.w);
    *hi = make_float4(acc[0][1] + qh.x, acc[0][3] + qh.y, acc[1][1] + qh.z, acc[1][3] + qh.w);
  }
  cluster_reduce_store<bf16>(P, out, rows, n_out, c0);
}

// ------------------------------------------------------- prefill (bf16)

constexpr int kPreThreads = 256;            // two warpgroups of 64 output columns
constexpr int kPreBM = 256, kPreBN = 128;   // x rows x output columns of a block
constexpr int kPreBK = 32;                  // packed rows per stage (64 contraction rows)
constexpr int kPreStages = 4;               // copies run 2 stages ahead of the math
constexpr int kPreTileX = kPreBM * 128;     // x tile: 128-byte rows in the 128B swizzle
constexpr int kPreRowW = kPreBN + 32;       // bytes per staged packed row
constexpr int kPreOffS = kPreTileX + kPreBK * kPreRowW;
constexpr int kPreRowO = kPreBN + 8;        // bf16 per staged output row (272 bytes)

__host__ __device__ inline int pre_stage_bytes(int ns) {
  return (kPreOffS + ns * kPreBN * 4 + kPreBK + 1023) / 1024 * 1024;
}
__host__ __device__ inline int pre_smem_bytes(int ns) {
  const int ring = kPreStages * pre_stage_bytes(ns), tile = kPreBM * kPreRowO * 2;
  return (ring > tile ? ring : tile) + 1024;  // + slack to align the ring to 1024
}

__global__ void __launch_bounds__(kPreThreads, 1)
int4_prefill_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ q4,
                    const float* __restrict__ s4, bf16* __restrict__ out, int rows,
                    int n_in, int n_out, int group, long long ldx, int ns) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (1024 - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) % 1024) % 1024;
  const int stage_bytes = pre_stage_bytes(ns);
  const int slot_off = kPreOffS + ns * kPreBN * 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wcol = (warp / 4) * 64 + (warp % 4) * 16;  // this warp's 16 columns
  const int r0 = blockIdx.y * kPreBM, c0 = blockIdx.x * kPreBN;
  const int n_pk = n_in / 2, gp = group / 2, n_groups = n_in / group;
  const int n_tiles = (n_pk + kPreBK - 1) / kPreBK;

  // A thread's copies of a stage, fixed but for the stage's packed rows:
  // x rows tid / 8 + 32k (k < 8), chunk tid % 8 (8 values); the weight row
  // tid / 8, chunk tid % 8 (16 bytes); scale rows tid / 32 + 8k (< ns),
  // chunk tid % 32 (4 values); the slot of packed row tid (tid < 32).
  const int xr = tid / 8, xc = tid % 8;
  const int x_rows = min(max(rows - r0 - xr, 0), 8 * 32);  // rows xr + 32k < this are live
  const bf16* x_src = x + (long long)(r0 + xr) * ldx + 8 * xc;
  const int x_dst = xr * 128 + ((xc ^ (xr & 7)) * 16);
  const bool w_col = c0 + xc * 16 < n_out;
  const uint8_t* w_src = q4 + (long long)xr * n_out + c0 + xc * 16;
  const int sr = tid / 32, sc = (tid % 32) * 4;
  const bool s_col = c0 + sc < n_out;
  auto issue = [&](int it) {
    unsigned char* st = smem + (it % kPreStages) * stage_bytes;
    const int p0 = it * kPreBK, g0 = p0 / gp;
    const bool x_k = 2 * p0 + 8 * xc < n_in;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool ok = x_k && 32 * k < x_rows;
      cp_async16(st + x_dst + k * 32 * 128, ok ? x_src + 32 * k * ldx + 2 * p0 : x, ok);
    }
    const bool w_ok = w_col && p0 + xr < n_pk;
    cp_async16(st + kPreTileX + xr * kPreRowW + xc * 16,
               w_ok ? w_src + (long long)p0 * n_out : q4, w_ok);
    for (int r = sr; r < ns; r += kPreThreads / 32) {
      const bool s_ok = s_col && g0 + r < n_groups;
      cp_async16(st + kPreOffS + (r * kPreBN + sc) * 4,
                 s_ok ? s4 + (long long)(g0 + r) * n_out + c0 + sc : s4, s_ok);
    }
    if (tid < kPreBK) st[slot_off + tid] = (unsigned char)(min(p0 + tid, n_pk - 1) / gp - g0);
  };

  // acc: this warpgroup's out^T tile, 64 columns x 256 rows of x; A row gid
  // of warp w is column wcol + 2 gid, row gid + 8 column wcol + 2 gid + 1.
  // The first product overwrites it (a zeroing store would serialize the
  // wgmmas).
  float acc[128];
#pragma unroll
  for (int it = 0; it < kPreStages - 2; ++it) {
    if (it < n_tiles) issue(it);
    hopper::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    hopper::cp_async_wait<kPreStages - 3>();  // this thread's copies of tile it
    hopper::fence_async_shared();
    // Every thread's copies of tile it have landed, and every warpgroup's
    // products of tile it - 2 are done (each waits for all but its last
    // group), so its stage takes the copies of tile it + 2.
    __syncthreads();
    if (it + kPreStages - 2 < n_tiles) issue(it + kPreStages - 2);
    hopper::cp_async_commit();
    const unsigned char* st = smem + (it % kPreStages) * stage_bytes;
    const uint64_t desc = hopper::desc_sw128(st);
    const unsigned char* W = st + kPreTileX + wcol + gid * 2;
    const float* S = reinterpret_cast<const float*>(st + kPreOffS) + wcol + gid * 2;
    const unsigned char* slot = st + slot_off;
#pragma unroll
    for (int ks = 0; ks < kPreBK / 8; ++ks) {
      // A: packed rows ra (a0, a1) and rb = ra + 4 (a2, a3), two columns'
      // bytes each, dequantized while the previous step's product runs. One
      // product a group, each step's A in registers of its own (the ks loop
      // is unrolled): a register a pending product reads is written again
      // only after the wait for it. (A stage-wide group, pending while the
      // next stage's A went into the same registers, gave NaN on the card.)
      const int ra = ks * 8 + tig, rb = ra + 4;
      const Nibbles na(*reinterpret_cast<const uint16_t*>(W + ra * kPreRowW));
      const Nibbles nb(*reinterpret_cast<const uint16_t*>(W + rb * kPreRowW));
      const float2 sa = *reinterpret_cast<const float2*>(S + slot[ra] * kPreBN);
      const float2 sb = *reinterpret_cast<const float2*>(S + slot[rb] * kPreBN);
      const uint32_t a[4] = {deq2(na, 0, sa.x), deq2(na, 1, sa.y), deq2(nb, 0, sb.x),
                             deq2(nb, 1, sb.y)};
      hopper::wgmma_fence();
      hopper::wgmma_m64n256k16_rs(acc, a, desc + 2 * ks, it > 0 || ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
    }
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 128; ++i) hopper::fence_operand(acc[i]);
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the output tile reuses it

  // acc[4j + e]: column wcol + 2 gid + e / 2, x row 8j + 2 tig + e % 2: two
  // adjacent columns of a row in one lane, one 4-byte store into the staged
  // tile; then the tile leaves in 16-byte writes, rows whole.
  bf16* O = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      *reinterpret_cast<uint32_t*>(O + (8 * j + 2 * tig + e) * kPreRowO + wcol + 2 * gid) =
          hopper::pack_bf16(acc[4 * j + e], acc[4 * j + 2 + e]);
    }
  }
  __syncthreads();
  for (int i = tid; i < kPreBM * kPreBN / 8; i += kPreThreads) {
    const int r = i / (kPreBN / 8), c = (i % (kPreBN / 8)) * 8;
    if (r0 + r < rows && c0 + c < n_out) {
      *reinterpret_cast<uint4*>(out + (long long)(r0 + r) * n_out + c0 + c) =
          *reinterpret_cast<const uint4*>(O + r * kPreRowO + c);
    }
  }
}

// ----------------------------------------------------------- rows (f32)

constexpr int kRowsThreads = 256;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kChunk = 128;  // packed rows of x staged per pass

template <int RB>
__global__ void __launch_bounds__(kRowsThreads)
int4_rows_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q4,
                 const float* __restrict__ s4, float* __restrict__ out, int rows,
                 int n_in, int n_out, int group, long long ldx, int kp_split) {
  __shared__ float xs[RB][2 * kChunk];
  __shared__ float red[kRowsWarps][kBN];
  __shared__ __align__(16) float P[kMaxRows * kBN];
  const int tid = threadIdx.x, cx = tid % 32, kg = tid / 32;
  const int c0 = blockIdx.x * kBN, col = c0 + cx * 4;
  const int r0 = blockIdx.z * RB;
  const int n_pk = n_in / 2;
  const int split = (int)cg::this_cluster().block_rank();
  const int p_beg = min(split * kp_split, n_pk), p_end = min(p_beg + kp_split, n_pk);
  const bool col_ok = col < n_out;  // n_out is a multiple of 16

  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int p0 = p_beg; p0 < p_end; p0 += kChunk) {
    const int p1 = min(p0 + kChunk, p_end);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < RB * 2 * kChunk; i += kRowsThreads) {
      const int r = i / (2 * kChunk), k = i % (2 * kChunk);
      const int row = r0 + r, ki = 2 * p0 + k;
      xs[r][k] = (row < rows && ki < 2 * p1) ? x[row * ldx + ki] : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    int g_prev = -1;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = p0 + kg; p < p1; p += kRowsWarps) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(q4 + (long long)p * n_out + col);
      const int g = 2 * p / group;  // a packed row never straddles a group
      if (g != g_prev) {
        s = *reinterpret_cast<const float4*>(s4 + (long long)g * n_out + col);
        g_prev = g;
      }
      const float sv[4] = {s.x, s.y, s.z, s.w};
      const int pp = 2 * (p - p0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wl = __fmul_rn(nib(w, 8 * j), sv[j]);
        const float wh = __fmul_rn(nib(w, 8 * j + 4), sv[j]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          acc[r][j] = fmaf(xs[r][pp], wl, acc[r][j]);
          acc[r][j] = fmaf(xs[r][pp + 1], wh, acc[r][j]);
        }
      }
    }
  }

  // Add the warps' partial sums of each row in a fixed order into P.
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) red[kg][cx * 4 + j] = acc[r][j];
    __syncthreads();
    if (tid < kBN) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kRowsWarps; ++i) sum += red[i][tid];
      P[r * kBN + tid] = sum;
    }
  }
  cluster_reduce_store<float>(P, out + (long long)r0 * n_out, min(RB, rows - r0), n_out, c0);
}

// ------------------------------------------------------------- launches

// Launch `kernel` over `grid` with clusters of (1, splits, 1) blocks.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, int smem, int splits,
                   cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Opt a kernel into `bytes` of dynamic shared memory, once.
int opt_in(const void* kernel, int bytes, bool* done) {
  if (*done) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  *done = true;
  return 0;
}

template <int RB>
int launch_rows(const float* x, const uint8_t* q4, const float* s4, float* out, int rows,
                int n_in, int n_out, int group, long long ldx, int splits, int kp_split,
                cudaStream_t st) {
  const dim3 grid((n_out + kBN - 1) / kBN, splits, (rows + RB - 1) / RB);
  return launch_cluster(int4_rows_kernel<RB>, grid, kRowsThreads, 0, splits, st, x, q4, s4,
                        out, rows, n_in, n_out, group, ldx, kp_split);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). x rows are
// `ldx` elements apart; n_in % 8 == 0, n_out % 16 == 0, group even and
// dividing n_in. `route` is the kernel (0: f32 rows, 1: bf16 decode, R <=
// 8, 2: bf16 prefill); with `splits` > 1 (routes 0 and 1, R <= 8) the
// contraction axis is split over a cluster of `splits` <= 8 blocks, each
// covering `kp_split` packed rows (a multiple of 4).
extern "C" int int4_matmul(const void* x, const void* q4, const void* s4, void* out,
                           int rows, int n_in, int n_out, int group, long long ldx,
                           int route, int splits, int kp_split, void* stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  if (splits < 1 || splits > 8 || (splits > 1 && rows > kMaxRows) || group < 2 ||
      group % 2 || kp_split % 4 || (long long)splits * kp_split < n_in / 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(q4);
  const float* s = static_cast<const float*>(s4);
  switch (route) {
    case kRouteDecode: {
      if (rows > kMaxRows) return (int)cudaErrorInvalidValue;
      const int ns = scale_slots(kDecBK, group / 2);
      if (kDecStages * dec_stage_bytes(ns) > kMaxSmem) return (int)cudaErrorInvalidValue;
      static bool done = false;
      int err = opt_in((const void*)int4_decode_kernel, kMaxSmem, &done);
      if (err) return err;
      const dim3 grid((n_out + kBN - 1) / kBN, splits);
      return launch_cluster(int4_decode_kernel, grid, kDecThreads,
                            kDecStages * dec_stage_bytes(ns), splits, st,
                            static_cast<const bf16*>(x), w, s, static_cast<bf16*>(out), rows,
                            n_in, n_out, group, ldx, kp_split, ns);
    }
    case kRoutePrefill: {
      if (splits != 1) return (int)cudaErrorInvalidValue;
      const int ns = scale_slots(kPreBK, group / 2);
      if (pre_smem_bytes(ns) > kMaxSmem) return (int)cudaErrorInvalidValue;
      static bool done = false;
      int err = opt_in((const void*)int4_prefill_kernel, kMaxSmem, &done);
      if (err) return err;
      const dim3 grid((n_out + kPreBN - 1) / kPreBN, (rows + kPreBM - 1) / kPreBM);
      int4_prefill_kernel<<<grid, kPreThreads, pre_smem_bytes(ns), st>>>(
          static_cast<const bf16*>(x), w, s, static_cast<bf16*>(out), rows, n_in, n_out,
          group, ldx, ns);
      return (int)cudaGetLastError();
    }
    case kRouteRows: {
      const float* xf = static_cast<const float*>(x);
      float* of = static_cast<float*>(out);
      switch (rows < kMaxRows ? rows : kMaxRows) {
        case 1: return launch_rows<1>(xf, w, s, of, rows, n_in, n_out, group, ldx, splits, kp_split, st);
        case 2: return launch_rows<2>(xf, w, s, of, rows, n_in, n_out, group, ldx, splits, kp_split, st);
        case 3: return launch_rows<3>(xf, w, s, of, rows, n_in, n_out, group, ldx, splits, kp_split, st);
        case 4: return launch_rows<4>(xf, w, s, of, rows, n_in, n_out, group, ldx, splits, kp_split, st);
        case 5: return launch_rows<5>(xf, w, s, of, rows, n_in, n_out, group, ldx, splits, kp_split, st);
        case 6: return launch_rows<6>(xf, w, s, of, rows, n_in, n_out, group, ldx, splits, kp_split, st);
        case 7: return launch_rows<7>(xf, w, s, of, rows, n_in, n_out, group, ldx, splits, kp_split, st);
        default: return launch_rows<8>(xf, w, s, of, rows, n_in, n_out, group, ldx, splits, kp_split, st);
      }
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
