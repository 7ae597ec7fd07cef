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
//     once, over 3.35 TB/s (wd of 7B: 24.6 MB, 7.3 us).
//   prefill (R = a chunk of hundreds of rows): 2 * R * IN * OUT FLOPs over
//     989 TFLOP/s.
//
// Design (a first, simple kernel of each kind):
//   * Rows kernel (R <= 8 in any type, and every R in f32). A thread owns 8
//     output columns: one 8-byte load of a packed row gives its 16 weights
//     (two contraction rows), so a warp reads 256 contiguous bytes per
//     packed row. The 8 warps of a block split the packed rows of the
//     block's slice, the x rows of that slice are staged in shared memory
//     as f32, and the scale row is looked up per packed row (a pair never
//     straddles a group: groups are even), never per tile. Every row of x
//     sits in registers, so the weight streams once for all R rows. With
//     few column tiles (decode) the contraction axis is split over grid.y
//     to fill the card: each split writes f32 partial sums and a second
//     small kernel adds them in order (deterministic). R > 8 (f32 only)
//     takes 8 rows per block over grid.z, the weight then coming from L2.
//     Launch bounds cap the registers at 128 a thread, for two blocks an SM
//     (uncapped, ptxas takes 180 at R = 8: one block of 8 warps an SM).
//   * Tensor-core kernel (bf16, R > 8: prefill). Tiles of 64 rows x 128
//     columns x 32 contraction rows: x's tile is copied to shared memory,
//     the weight tile is unpacked and scaled to bf16 in shared memory by
//     each thread (16 columns of one packed row), and four warps run WMMA
//     16x16x16 bf16 products with f32 accumulators. Single buffered.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float out(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 out(float x) { return __float2bfloat16(x); }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

__device__ __forceinline__ float nib_lo(uint32_t byte) { return (float)((int)(byte & 15u) - 8); }
__device__ __forceinline__ float nib_hi(uint32_t byte) { return (float)((int)(byte >> 4) - 8); }

// ------------------------------------------------------------ rows kernel

constexpr int kRowsThreads = 256;
constexpr int kCols = 8;                 // output columns per thread
constexpr int kTileCols = 32 * kCols;    // 256 columns per block
constexpr int kKGroups = kRowsThreads / 32;
constexpr int kChunk = 128;              // packed rows of x staged per pass

template <typename T, int RB>
__global__ void __launch_bounds__(kRowsThreads, 2)
int4_rows_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q4,
                 const float* __restrict__ s4, float* __restrict__ part,
                 T* __restrict__ out, int rows, int n_in, int n_out, int group,
                 int kp_split, long long ldx) {
  __shared__ float xs[RB][2 * kChunk];
  __shared__ float red[kKGroups][kTileCols];
  const int tid = threadIdx.x, cx = tid & 31, kg = tid >> 5;
  const int col = blockIdx.x * kTileCols + cx * kCols;
  const int r0 = blockIdx.z * RB;
  const int p_beg = blockIdx.y * kp_split;
  const int p_end = min(p_beg + kp_split, n_in / 2);
  const bool col_ok = col < n_out;  // n_out is a multiple of 8

  float acc[RB][kCols];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  }

  for (int c0 = p_beg; c0 < p_end; c0 += kChunk) {
    const int c1 = min(c0 + kChunk, p_end);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < RB * 2 * kChunk; i += kRowsThreads) {
      const int r = i / (2 * kChunk), k = i % (2 * kChunk);
      const int row = r0 + r, ki = 2 * c0 + k;
      xs[r][k] = (row < rows && ki < 2 * c1) ? to_f32(x[row * ldx + ki]) : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    int g_prev = -1;
    float s[kCols];
    for (int p = c0 + kg; p < c1; p += kKGroups) {
      const uint2 raw = *reinterpret_cast<const uint2*>(q4 + (long long)p * n_out + col);
      const int g = 2 * p / group;
      if (g != g_prev) {
        const float4* sp = reinterpret_cast<const float4*>(s4 + (long long)g * n_out + col);
        const float4 a = sp[0], b = sp[1];
        s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
        s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
        g_prev = g;
      }
      const int pp = 2 * (p - c0);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const uint32_t byte = ((j < 4 ? raw.x : raw.y) >> (8 * (j & 3))) & 0xFFu;
        const float wl = Cvt<T>::round(nib_lo(byte) * s[j]);
        const float wh = Cvt<T>::round(nib_hi(byte) * s[j]);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          acc[r][j] = fmaf(xs[r][pp], wl, acc[r][j]);
          acc[r][j] = fmaf(xs[r][pp + 1], wh, acc[r][j]);
        }
      }
    }
  }

  // Add the warps' partial sums of each row in a fixed order, then write the
  // row (or this split's partial row).
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[kg][cx * kCols + j] = acc[r][j];
    __syncthreads();
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKGroups; ++i) sum += red[i][tid];
    const int row = r0 + r, c = blockIdx.x * kTileCols + tid;
    if (row < rows && c < n_out) {
      if (part != nullptr) {
        part[((long long)blockIdx.y * rows + row) * n_out + c] = sum;
      } else {
        out[(long long)row * n_out + c] = Cvt<T>::out(sum);
      }
    }
  }
}

template <typename T>
__global__ void int4_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                                   int splits, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int k = 0; k < splits; ++k) sum += part[k * n + i];
  out[i] = Cvt<T>::out(sum);
}

template <typename T, int RB>
int launch_rows(const T* x, const uint8_t* q4, const float* s4, float* part, T* out,
                int rows, int n_in, int n_out, int group, long long ldx, int splits,
                int kp_split, cudaStream_t st) {
  const dim3 grid((n_out + kTileCols - 1) / kTileCols, splits, (rows + RB - 1) / RB);
  int4_rows_kernel<T, RB><<<grid, kRowsThreads, 0, st>>>(
      x, q4, s4, splits > 1 ? part : nullptr, out, rows, n_in, n_out, group, kp_split,
      ldx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n = (long long)rows * n_out;
  int4_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, out, splits, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows_any(const T* x, const uint8_t* q4, const float* s4, float* part, T* out,
                    int rows, int n_in, int n_out, int group, long long ldx, int splits,
                    int kp_split, cudaStream_t st) {
  switch (rows < 8 ? rows : 8) {
    case 1: return launch_rows<T, 1>(x, q4, s4, part, out, rows, n_in, n_out, group, ldx, splits, kp_split, st);
    case 2: return launch_rows<T, 2>(x, q4, s4, part, out, rows, n_in, n_out, group, ldx, splits, kp_split, st);
    case 3: return launch_rows<T, 3>(x, q4, s4, part, out, rows, n_in, n_out, group, ldx, splits, kp_split, st);
    case 4: return launch_rows<T, 4>(x, q4, s4, part, out, rows, n_in, n_out, group, ldx, splits, kp_split, st);
    case 5: return launch_rows<T, 5>(x, q4, s4, part, out, rows, n_in, n_out, group, ldx, splits, kp_split, st);
    case 6: return launch_rows<T, 6>(x, q4, s4, part, out, rows, n_in, n_out, group, ldx, splits, kp_split, st);
    case 7: return launch_rows<T, 7>(x, q4, s4, part, out, rows, n_in, n_out, group, ldx, splits, kp_split, st);
    default: return launch_rows<T, 8>(x, q4, s4, part, out, rows, n_in, n_out, group, ldx, splits, kp_split, st);
  }
}

// ----------------------------------------------------- tensor-core kernel

constexpr int kBM = 64, kBN = 128, kBK = 32, kMmaThreads = 128;
constexpr int kLdA = kBK + 8;   // bf16 elements; rows stay 16-byte aligned
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;   // f32
constexpr int kSmemAB = (kBM * kLdA + kBK * kLdB) * 2;
constexpr int kSmemC = kBM * kLdC * 4;
constexpr int kSmem = kSmemC > kSmemAB ? kSmemC : kSmemAB;

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // .x = a at the lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kMmaThreads)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q4,
                const float* __restrict__ s4, __nv_bfloat16* __restrict__ out, int rows,
                int n_in, int n_out, int group, long long ldx) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + kBM * kLdA;
  float* Cs = reinterpret_cast<float*>(smem);  // after the K loop only
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;      // 2 x 2 warps of 32 x 64
  const int r0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  // The weight-tile thread map: packed row pr of the tile, 16 columns.
  const int pr = tid / (kBN / 16), cc = (tid % (kBN / 16)) * 16;
  for (int k0 = 0; k0 < n_in; k0 += kBK) {
    // x tile [64, 32]: 16-byte chunks, zeros past the rows or the end of IN.
    for (int i = tid; i < kBM * kBK / 8; i += kMmaThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const int row = r0 + r, k = k0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows && k < n_in) val = *reinterpret_cast<const uint4*>(x + row * ldx + k);
      *reinterpret_cast<uint4*>(As + r * kLdA + c) = val;
    }
    // Weight tile [32, 128]: packed row p gives contraction rows 2p, 2p+1.
    {
      const int p = k0 / 2 + pr, col = c0 + cc;
      uint32_t lo[8], hi[8];
      if (p < n_in / 2 && col < n_out) {
        const uint4 raw = *reinterpret_cast<const uint4*>(q4 + (long long)p * n_out + col);
        const float4* sp = reinterpret_cast<const float4*>(s4 + (long long)(2 * p / group) * n_out + col);
        const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 s = sp[q];
          const float sv[4] = {s.x, s.y, s.z, s.w};
          float l[4], h[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t byte = (wd[q] >> (8 * e)) & 0xFFu;
            l[e] = nib_lo(byte) * sv[e];
            h[e] = nib_hi(byte) * sv[e];
          }
          lo[2 * q] = pack_bf16(l[0], l[1]);
          lo[2 * q + 1] = pack_bf16(l[2], l[3]);
          hi[2 * q] = pack_bf16(h[0], h[1]);
          hi[2 * q + 1] = pack_bf16(h[2], h[3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) lo[q] = hi[q] = 0u;
      }
      uint4* blo = reinterpret_cast<uint4*>(Bs + (2 * pr) * kLdB + cc);
      uint4* bhi = reinterpret_cast<uint4*>(Bs + (2 * pr + 1) * kLdB + cc);
      blo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      blo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      bhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      bhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdB + wn * 64 + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * kLdC + wn * 64 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < kBM * kBN / 8; i += kMmaThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    const int row = r0 + r, col = c0 + c;
    if (row < rows && col < n_out) {
      const float* cp = Cs + r * kLdC + c;
      *reinterpret_cast<uint4*>(out + (long long)row * n_out + col) =
          make_uint4(pack_bf16(cp[0], cp[1]), pack_bf16(cp[2], cp[3]),
                     pack_bf16(cp[4], cp[5]), pack_bf16(cp[6], cp[7]));
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = launched). x rows are
// `ldx` elements apart; n_in % 8 == 0, n_out % 16 == 0, group even and
// dividing n_in. `part` is f32 scratch of splits * rows * n_out (used when
// splits > 1, which needs rows <= 8); each split covers `kp_split` packed
// rows. bf16 with rows > 8 takes the tensor-core kernel.
extern "C" int int4_matmul(const void* x, const void* q4, const void* s4, void* part,
                           void* out, int rows, int n_in, int n_out, int group,
                           long long ldx, int is_bf16, int splits, int kp_split,
                           void* stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  if (splits < 1 || (splits > 1 && rows > 8) || group < 2 || group % 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(q4);
  const float* s = static_cast<const float*>(s4);
  float* pt = static_cast<float*>(part);
  if (is_bf16 && rows > 8) {
    const dim3 grid((n_out + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
    int4_mma_kernel<<<grid, kMmaThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w, s, static_cast<__nv_bfloat16*>(out), rows,
        n_in, n_out, group, ldx);
    return (int)cudaGetLastError();
  }
  if (is_bf16) {
    return launch_rows_any<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), w, s, pt, static_cast<__nv_bfloat16*>(out),
        rows, n_in, n_out, group, ldx, splits, kp_split, st);
  }
  return launch_rows_any<float>(static_cast<const float*>(x), w, s, pt,
                                static_cast<float*>(out), rows, n_in, n_out, group, ldx,
                                splits, kp_split, st);
}
