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
//     wg: 45.1 MB, 13.5 us; the 7B unembed 131 MB, 39 us);
//   prefill (R in the hundreds): 2 * R * IN * OUT operations over the
//     tensor cores (wg at R = 1024: 92 GFLOP, 93 us), which mma.sync reaches
//     only in part; the conversion of each weight to bf16, once per 64 rows
//     of x, competes with the products for issue slots.
//
// Design. Three kernels; the Python wrapper picks one by a single rule
// (`int8mm.int8_route`) and passes it as `route`:
//   * GEMV, io layout (bf16 x of R <= 8, f32 x over blocks of 8 rows): a
//     block owns 256 output columns, a lane 8 adjacent columns (one 8-byte
//     load a contraction row: a warp reads 256 contiguous bytes of a row),
//     the eight warps interleave the contraction rows, four rows' loads in
//     flight before their products. An int8 byte becomes an exact f32 with
//     two instructions (a byte_perm into the mantissa of 2**23 + q + 128,
//     one subtraction); x is staged in shared memory as f32 [k][8 rows] and
//     read as broadcast float4s. The warps' partial sums are added in a
//     fixed order; the contraction axis is split over a thread-block cluster
//     of up to 8 blocks (cluster dims (1, splits, 1)), whose partial tiles
//     are added through distributed shared memory in cluster-rank order,
//     then scaled and written. One launch; no f32 scratch in device memory.
//   * GEMV, vd layout (the unembed at decode): a warp owns 4 table rows, its
//     lanes walk the hidden axis in 4-byte words (each warp load is 128
//     contiguous bytes of a row), x staged as f32 [8 rows][512] and read as
//     conflict-free float4s; a butterfly of shuffles adds the lanes (every
//     lane ends with the same sum) and lane 4 * row + r writes logit (r,
//     row). 32 table rows a block fill the card without a split.
//   * Tensor cores (bf16 x, R > 8): mma.sync.m16n8k16, tiles of 64 rows of x
//     x 128 output columns x 32 contraction rows, four warps of 32 x 64. x
//     arrives by 16-byte cp.async; the int8 weight tile is loaded into
//     registers one tile ahead of the products, converted to bf16 (exact)
//     and stored into the other of two shared-memory stages; ldmatrix reads
//     the fragments (transposed for the io layout's [k][n] tile, plainly for
//     the vd layout's [n][k] one). f32 accumulators; the epilogue scales and
//     stores two adjacent columns a lane. No split: deterministic.

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
enum Route { kRouteGemv = 0, kRouteMma = 1 };

constexpr int kMaxRows = 8;    // rows of x a GEMV block covers
constexpr int kThreads = 256;  // GEMV blocks: eight warps
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kBias = 0x80808080u;  // int8 q -> byte q + 128

// Element j of a word of four int8 values, already XORed with kBias, as an
// exact f32: 2**23 + (q + 128), minus 2**23 + 128.
__device__ __forceinline__ float i8f(uint32_t wb, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(wb, 0x4B000000u, 0x7440 | j)), 8388736.f);
}

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float in(float x) { return x; }
  static __device__ __forceinline__ float out(float x) { return x; }
};
template <> struct Cvt<bf16> {
  static __device__ __forceinline__ float in(bf16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ bf16 out(float x) { return __float2bfloat16(x); }
};

// ------------------------------------------------------------ GEMV, io

constexpr int kGemvBN = 256;  // output columns of a block: 8 a lane
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

template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
int8_gemv_io_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ s, T* __restrict__ out, int rows, int n_in,
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
      xs[k][r] = (r < nr && k < n) ? Cvt<T>::in(x[(long long)(r0 + r) * ldx + p0 + k]) : 0.f;
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
      out[(long long)(r0 + r) * n_out + c] = Cvt<T>::out(sum * s[c]);
    }
  }
  cluster.sync();  // every tile stays alive until all reads are done
}

// ------------------------------------------------------------ GEMV, vd

constexpr int kVdRowsW = 4;                  // table rows a warp
constexpr int kVdBV = kWarps * kVdRowsW;     // table rows a block
constexpr int kVdDC = 512;                   // hidden values of x staged a pass

template <typename T, int RB>
__global__ void __launch_bounds__(kThreads)
int8_gemv_vd_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
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
      xs[r][d] = (r < nr && d < n) ? Cvt<T>::in(x[(long long)(r0 + r) * ldx + d0 + d]) : 0.f;
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

// ------------------------------------------------------ tensor cores

constexpr int kMmaThreads = 128;                 // four warps of 32 x 64
constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kXS = kBK + 8;                     // bf16 a staged x row (80 bytes)
constexpr int kWSio = kBN + 8;                   // io: a staged [k] row of 128 columns
constexpr int kWSvd = kBK + 8;                   // vd: a staged table row of 32 values
template <int L> struct WTile {
  static constexpr int kElems = L == kIO ? kBK * kWSio : kBN * kWSvd;
};

template <typename OutT> struct Store2;
template <> struct Store2<bf16> {
  static __device__ __forceinline__ void st(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(a, b);
  }
};
template <> struct Store2<float> {
  static __device__ __forceinline__ void st(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <int L, typename OutT>
__global__ void __launch_bounds__(kMmaThreads)
int8_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ s, OutT* __restrict__ out, int rows, int n_in,
                int n_out, long long ldx) {
  __shared__ __align__(16) bf16 Xs[2][kBM * kXS];
  __shared__ __align__(16) bf16 Ws[2][WTile<L>::kElems];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp % 2, wn = warp / 2;  // 32 rows x 64 columns a warp
  const int r0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  const int n_tiles = (n_in + kBK - 1) / kBK;

  // Stage copies, two 16-byte chunks a thread: x chunk c = row c / 4,
  // values 8 (c % 4); weight chunk c (16 int8) = io: contraction row c / 8,
  // columns 16 (c % 8); vd: table row c / 2, values 16 (c % 2).
  auto load_x = [&](int it, int buf) {
    const int k0 = it * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kMmaThreads * i, row = c / 4, kc = (c % 4) * 8;
      const bool ok = r0 + row < rows && k0 + kc < n_in;
      cp_async16(&Xs[buf][row * kXS + kc], ok ? x + (long long)(r0 + row) * ldx + k0 + kc : x,
                 ok);
    }
  };
  auto load_w = [&](int it, uint4 (&reg)[2]) {
    const int k0 = it * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kMmaThreads * i;
      bool ok;
      const int8_t* src;
      if (L == kIO) {
        const int kr = c / 8, nc = (c % 8) * 16;
        ok = k0 + kr < n_in && c0 + nc < n_out;
        src = w + (long long)(k0 + kr) * n_out + c0 + nc;
      } else {
        const int vr = c / 2, kc = (c % 2) * 16;
        ok = c0 + vr < n_out && k0 + kc < n_in;
        src = w + (long long)(c0 + vr) * n_in + k0 + kc;
      }
      reg[i] = ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_w = [&](const uint4 (&reg)[2], int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kMmaThreads * i;
      bf16* dst = L == kIO ? &Ws[buf][(c / 8) * kWSio + (c % 8) * 16]
                           : &Ws[buf][(c / 2) * kWSvd + (c % 2) * 16];
      const uint32_t wd[4] = {reg[i].x ^ kBias, reg[i].y ^ kBias, reg[i].z ^ kBias,
                              reg[i].w ^ kBias};
      uint32_t h[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[2 * j] = hopper::pack_bf16(i8f(wd[j], 0), i8f(wd[j], 1));
        h[2 * j + 1] = hopper::pack_bf16(i8f(wd[j], 2), i8f(wd[j], 3));
      }
      reinterpret_cast<uint4*>(dst)[0] = make_uint4(h[0], h[1], h[2], h[3]);
      reinterpret_cast<uint4*>(dst)[1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
    }
  }
  uint4 reg[2];
  load_x(0, 0);
  hopper::cp_async_commit();
  load_w(0, reg);
  store_w(reg, 0);
  for (int it = 0; it < n_tiles; ++it) {
    hopper::cp_async_wait<0>();
    // Tile it is in stage it % 2 (x copied, the weight stored by every
    // thread), and every warp's products of tile it - 1 are done, so the
    // other stage takes tile it + 1.
    __syncthreads();
    const int buf = it & 1;
    const bool next = it + 1 < n_tiles;
    if (next) {
      load_x(it + 1, buf ^ 1);
      hopper::cp_async_commit();
      load_w(it + 1, reg);  // in flight behind this tile's products
    }
    const bf16* X = Xs[buf];
    const bf16* W = Ws[buf];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        hopper::ldsm_x4(a[mi], X + (wm * 32 + mi * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kXS +
                                   ks * 16 + (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // b[0], b[1]: columns 16 p .. + 7 of the warp's 64; b[2], b[3]: the
        // next 8.
        uint32_t b[4];
        if (L == kIO) {
          hopper::ldsm_x4_trans(b, W + (ks * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kWSio +
                                       wn * 64 + p * 16 + (lane / 16) * 8);
        } else {
          hopper::ldsm_x4(b, W + (wn * 64 + p * 16 + lane % 8 + (lane / 16) * 8) * kWSvd +
                                 ks * 16 + ((lane / 8) % 2) * 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          hopper::mma_bf16(acc[mi][2 * p], a[mi], b[0], b[1]);
          hopper::mma_bf16(acc[mi][2 * p + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (next) store_w(reg, buf ^ 1);
  }

  // acc[mi][nj]: rows 16 mi + gid (+ 8 for e >= 2) of the warp's 32,
  // columns 8 nj + 2 tig, + 1 of its 64.
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const int col = c0 + wn * 64 + nj * 8 + 2 * tig;
    if (col >= n_out) continue;
    const float s0 = s[col], s1 = s[col + 1];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + wm * 32 + mi * 16 + gid + 8 * h;
        if (row < rows)
          Store2<OutT>::st(out + (long long)row * n_out + col, acc[mi][nj][2 * h] * s0,
                           acc[mi][nj][2 * h + 1] * s1);
      }
    }
  }
}

// ------------------------------------------------------------- launches

template <typename T, int RB>
int launch_gemv(int layout, const void* x, const int8_t* w, const float* s, void* out,
                int rows, int n_in, int n_out, long long ldx, int splits, int k_split,
                cudaStream_t st) {
  const int zb = (rows + kMaxRows - 1) / kMaxRows;
  if (layout == kIO) {
    const dim3 grid((n_out + kGemvBN - 1) / kGemvBN, splits, zb);
    return hopper::launch_cluster(int8_gemv_io_kernel<T, RB>, grid, kThreads, 0, splits, st,
                                  static_cast<const T*>(x), w, s, static_cast<T*>(out), rows,
                                  n_in, n_out, ldx, k_split);
  }
  const dim3 grid((n_out + kVdBV - 1) / kVdBV, 1, zb);
  int8_gemv_vd_kernel<T, RB><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), w, s, static_cast<float*>(out), rows, n_in, n_out, ldx);
  return (int)cudaGetLastError();
}

template <typename T>
int gemv_rows(int layout, const void* x, const int8_t* w, const float* s, void* out, int rows,
              int n_in, int n_out, long long ldx, int splits, int k_split, cudaStream_t st) {
  switch (rows < kMaxRows ? rows : kMaxRows) {
    case 1: return launch_gemv<T, 1>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 2: return launch_gemv<T, 2>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 3: return launch_gemv<T, 3>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 4: return launch_gemv<T, 4>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 5: return launch_gemv<T, 5>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 6: return launch_gemv<T, 6>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case 7: return launch_gemv<T, 7>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
    default: return launch_gemv<T, 8>(layout, x, w, s, out, rows, n_in, n_out, ldx, splits, k_split, st);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). x rows are
// `ldx` elements apart; n_in % 16 == 0 and n_out % 16 == 0 (n_out is V for
// the vd layout); `x_f32` says x (and the io output) is f32, else bf16; the
// vd output is f32. `route` 0 is the GEMV (f32 x, or bf16 x of at most 8
// rows), 1 the tensor cores (bf16 x). With `splits` > 1 (the io GEMV only)
// the contraction axis is split over a cluster of `splits` <= 8 blocks, each
// covering `k_split` contraction rows.
extern "C" int int8_matmul(const void* x, const void* q8, const void* s, void* out, int rows,
                           int n_in, int n_out, long long ldx, int x_f32, int layout,
                           int route, int splits, int k_split, void* stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  if (n_in <= 0 || n_in % 16 || n_out % 16 || (layout != kIO && layout != kVD) ||
      splits < 1 || splits > 8 || (splits > 1 && (layout != kIO || route != kRouteGemv)) ||
      k_split <= 0 || (long long)splits * k_split < n_in)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(q8);
  const float* sc = static_cast<const float*>(s);
  switch (route) {
    case kRouteGemv:
      if (x_f32) return gemv_rows<float>(layout, x, w, sc, out, rows, n_in, n_out, ldx, splits, k_split, st);
      if (rows > kMaxRows) return (int)cudaErrorInvalidValue;
      return gemv_rows<bf16>(layout, x, w, sc, out, rows, n_in, n_out, ldx, splits, k_split, st);
    case kRouteMma: {
      if (x_f32) return (int)cudaErrorInvalidValue;
      const dim3 grid((n_out + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
      const bf16* xb = static_cast<const bf16*>(x);
      if (layout == kIO)
        int8_mma_kernel<kIO, bf16><<<grid, kMmaThreads, 0, st>>>(
            xb, w, sc, static_cast<bf16*>(out), rows, n_in, n_out, ldx);
      else
        int8_mma_kernel<kVD, float><<<grid, kMmaThreads, 0, st>>>(
            xb, w, sc, static_cast<float*>(out), rows, n_in, n_out, ldx);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
