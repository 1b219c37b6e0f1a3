// Dual-stream QMC matmul y[M, N] = x[M, K] @ W for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/qmm.py:
//   * qmm_decode   <- qmm_pallas           (body _qmm_kernel), decode widths
//   * qmm_colstrip <- qmm_pallas_colstrip  (body _qmm_colstrip_kernel), M >= 128
//
// W is stored as (8, 128) subtiles. Subtile (gi, j) lives in the outlier
// stream (out_codes[stream_pos[gi, j]], 5-bit codes) when is_out[gi, j],
// else in the inlier stream (in_codes[stream_pos[gi, j]], 3-bit codes);
// both are int8 containers of 1024 codes. Its value is code * scale of the
// owning stream, per output column. Accumulation is fp32; y takes x's type.
//
// What bounds them on an H100:
//   * decode: memory. Every code byte (K*N of them) is read once, and a
//     decode step does 2*M FLOPs per byte at M <= 8. The design reads only
//     the owning stream's 1 KB subtile (the TPU's _hold_tables DMA elision
//     has no counterpart: a GPU thread simply does not load the dead
//     stream), with 4-byte loads so one warp reads a whole 128-byte subtile
//     row. N/128 strips is only 16 blocks at N = 2048, so K is split over
//     blocks; the partial sums go to an fp32 workspace and a second pass
//     adds them in a fixed order (deterministic, no atomics).
//   * colstrip: arithmetic at M >= 128 (2*M FLOPs per code byte). Each
//     block dequantizes 4 subtile rows at a time into a shared fp32
//     staging tile (32 x 128) and runs an fp32 CUDA-core product with an
//     8 x 8 register tile per thread. At N = 2048 and M = 128 there are
//     only 16 output tiles, so K is split over blocks here too (same
//     workspace and fixed-order second pass as decode) until about two
//     blocks per SM are in flight. Tensor cores (wgmma) are later work;
//     until then the fp32 peak (67 TFLOP/s) bounds it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB_R = 8;
constexpr int SUB_C = 128;
constexpr int SUB_ELEMS = SUB_R * SUB_C;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// ---------------------------------------------------------------------------
// decode width: block = (128-column strip, 8-row M tile, K split)
// ---------------------------------------------------------------------------
constexpr int DEC_WARPS = 4;    // warps share the block's subtile rows
constexpr int DEC_M = 8;        // x rows per block
constexpr int DEC_KCHUNK = 32;  // subtile rows of x staged at a time (256 K)

template <typename T>
__global__ void __launch_bounds__(DEC_WARPS * 32)
qmm_decode_kernel(const T* __restrict__ x, const int8_t* __restrict__ in_codes,
                  const int8_t* __restrict__ out_codes,
                  const int32_t* __restrict__ stream_pos,
                  const uint8_t* __restrict__ is_out,
                  const float* __restrict__ scale_in,
                  const float* __restrict__ scale_out,
                  float* __restrict__ partial, int M, int K, int N,
                  int rows_per_split) {
  __shared__ float xs[DEC_M][DEC_KCHUNK * SUB_R];
  __shared__ float red[DEC_WARPS][DEC_M][SUB_C];

  const int strip = blockIdx.x;
  const int m0 = blockIdx.y * DEC_M;
  const int split = blockIdx.z;
  const int gc = N / SUB_C;
  const int gr = K / SUB_R;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col0 = strip * SUB_C + lane * 4;  // this thread's 4 columns
  const int gi_begin = split * rows_per_split;
  const int gi_end = min(gr, gi_begin + rows_per_split);

  float s_in[4], s_out[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s_in[c] = scale_in[col0 + c];
    s_out[c] = scale_out[col0 + c];
  }
  float acc[DEC_M][4];
#pragma unroll
  for (int mm = 0; mm < DEC_M; ++mm)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[mm][c] = 0.f;

  for (int g0 = gi_begin; g0 < gi_end; g0 += DEC_KCHUNK) {
    const int g1 = min(gi_end, g0 + DEC_KCHUNK);
    const int nk = (g1 - g0) * SUB_R;
    __syncthreads();  // the previous chunk's x is consumed
    for (int i = threadIdx.x; i < DEC_M * nk; i += blockDim.x) {
      const int mm = i / nk, kk = i - mm * nk;
      xs[mm][kk] = to_f32(x[(size_t)(m0 + mm) * K + g0 * SUB_R + kk]);
    }
    __syncthreads();
    for (int gi = g0 + warp; gi < g1; gi += DEC_WARPS) {
      const int t = gi * gc + strip;
      const bool o = is_out[t] != 0;
      const int8_t* sub =
          (o ? out_codes : in_codes) + (size_t)stream_pos[t] * SUB_ELEMS;
      const int kb = (gi - g0) * SUB_R;
#pragma unroll
      for (int r = 0; r < SUB_R; ++r) {
        const char4 q =
            *reinterpret_cast<const char4*>(sub + r * SUB_C + lane * 4);
        const float w0 = (float)q.x * (o ? s_out[0] : s_in[0]);
        const float w1 = (float)q.y * (o ? s_out[1] : s_in[1]);
        const float w2 = (float)q.z * (o ? s_out[2] : s_in[2]);
        const float w3 = (float)q.w * (o ? s_out[3] : s_in[3]);
#pragma unroll
        for (int mm = 0; mm < DEC_M; ++mm) {
          const float xv = xs[mm][kb + r];
          acc[mm][0] = fmaf(xv, w0, acc[mm][0]);
          acc[mm][1] = fmaf(xv, w1, acc[mm][1]);
          acc[mm][2] = fmaf(xv, w2, acc[mm][2]);
          acc[mm][3] = fmaf(xv, w3, acc[mm][3]);
        }
      }
    }
  }
#pragma unroll
  for (int mm = 0; mm < DEC_M; ++mm)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][mm][lane * 4 + c] = acc[mm][c];
  __syncthreads();
  for (int i = threadIdx.x; i < DEC_M * SUB_C; i += blockDim.x) {
    const int mm = i / SUB_C, cc = i - mm * SUB_C;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) s += red[w][mm][cc];
    partial[((size_t)split * M + m0 + mm) * N + strip * SUB_C + cc] = s;
  }
}

// Adds the K-split partial sums in split order and casts to y's type.
template <typename T>
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  T* __restrict__ y, int splits, size_t mn) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * mn + i];
    y[i] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// column strip: block = one 128 x 128 output tile
// ---------------------------------------------------------------------------
constexpr int CS_BM = 128;
constexpr int CS_BN = 128;
constexpr int CS_BK = 32;  // 4 subtile rows per K step
constexpr int CS_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(CS_THREADS)
qmm_colstrip_kernel(const T* __restrict__ x,
                    const int8_t* __restrict__ in_codes,
                    const int8_t* __restrict__ out_codes,
                    const int32_t* __restrict__ stream_pos,
                    const uint8_t* __restrict__ is_out,
                    const float* __restrict__ scale_in,
                    const float* __restrict__ scale_out,
                    float* __restrict__ partial, T* __restrict__ y, int M,
                    int K, int N, int k_per_split) {
  __shared__ float xs[CS_BK][CS_BM + 4];  // x tile, k-major
  __shared__ float ws[CS_BK][CS_BN];      // dequantized staging tile

  const int strip = blockIdx.x;
  const int mt = blockIdx.y;
  const int split = blockIdx.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int gc = N / SUB_C;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int dc = threadIdx.x % CS_BN;  // staging column of this thread
  const int dr0 = threadIdx.x / CS_BN;  // first staging row (0 or 1)
  const float s_in = scale_in[strip * CS_BN + dc];
  const float s_out = scale_out[strip * CS_BN + dc];

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += CS_BK) {
#pragma unroll
    for (int i = 0; i < (CS_BM * CS_BK) / CS_THREADS; ++i) {
      const int idx = threadIdx.x + CS_THREADS * i;
      const int m = idx / CS_BK, kk = idx % CS_BK;
      xs[kk][m] = to_f32(x[(size_t)(mt * CS_BM + m) * K + k0 + kk]);
    }
#pragma unroll
    for (int i = 0; i < CS_BK / 2; ++i) {
      const int r = dr0 + 2 * i;
      const int gi = (k0 + r) / SUB_R;
      const int rr = (k0 + r) % SUB_R;
      const int t = gi * gc + strip;
      const bool o = is_out[t] != 0;
      const int8_t* sub =
          (o ? out_codes : in_codes) + (size_t)stream_pos[t] * SUB_ELEMS;
      ws[r][dc] = (float)sub[rr * SUB_C + dc] * (o ? s_out : s_in);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < CS_BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // one split writes y; several write their fp32 partial sums
  float* part = partial ? partial + (size_t)split * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const size_t at =
          (size_t)(mt * CS_BM + ty + 16 * i) * N + strip * CS_BN + tx + 16 * j;
      if (part)
        part[at] = acc[i][j];
      else
        y[at] = from_f32<T>(acc[i][j]);
    }
}

template <typename T>
int launch_reduce(const void* partial, void* y, int splits, size_t mn,
                  cudaStream_t stream) {
  const int threads = 256;
  const size_t want = (mn + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  qmm_reduce_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(y), splits, mn);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const void* x, const void* in_codes, const void* out_codes,
                  const void* stream_pos, const void* is_out,
                  const void* scale_in, const void* scale_out, void* partial,
                  void* y, int M, int K, int N, int splits,
                  int rows_per_split, cudaStream_t stream) {
  dim3 grid(N / SUB_C, M / DEC_M, splits);
  qmm_decode_kernel<T><<<grid, DEC_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(in_codes),
      static_cast<const int8_t*>(out_codes),
      static_cast<const int32_t*>(stream_pos),
      static_cast<const uint8_t*>(is_out),
      static_cast<const float*>(scale_in),
      static_cast<const float*>(scale_out), static_cast<float*>(partial), M,
      K, N, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce<T>(partial, y, splits, (size_t)M * N, stream);
}

template <typename T>
int launch_colstrip(const void* x, const void* in_codes,
                    const void* out_codes, const void* stream_pos,
                    const void* is_out, const void* scale_in,
                    const void* scale_out, void* partial, void* y, int M,
                    int K, int N, int splits, int k_per_split,
                    cudaStream_t stream) {
  dim3 grid(N / CS_BN, M / CS_BM, splits);
  qmm_colstrip_kernel<T><<<grid, CS_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(in_codes),
      static_cast<const int8_t*>(out_codes),
      static_cast<const int32_t*>(stream_pos),
      static_cast<const uint8_t*>(is_out),
      static_cast<const float*>(scale_in),
      static_cast<const float*>(scale_out),
      splits > 1 ? static_cast<float*>(partial) : nullptr,
      static_cast<T*>(y), M, K, N, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return launch_reduce<T>(partial, y, splits, (size_t)M * N, stream);
}

}  // namespace

extern "C" {

// x_bf16 selects the activation type (0: fp32, 1: bf16); y has x's type.
// partial is an fp32 workspace of splits * M * N. Returns cudaGetLastError().
int qmc_qmm_decode(const void* x, int x_bf16, const void* in_codes,
                   const void* out_codes, const void* stream_pos,
                   const void* is_out, const void* scale_in,
                   const void* scale_out, void* partial, void* y, int M,
                   int K, int N, int splits, int rows_per_split,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_decode<__nv_bfloat16>(x, in_codes, out_codes, stream_pos,
                                        is_out, scale_in, scale_out, partial,
                                        y, M, K, N, splits, rows_per_split, s);
  return launch_decode<float>(x, in_codes, out_codes, stream_pos, is_out,
                              scale_in, scale_out, partial, y, M, K, N,
                              splits, rows_per_split, s);
}

// k_per_split is a multiple of 32; with splits == 1 partial is unused.
int qmc_qmm_colstrip(const void* x, int x_bf16, const void* in_codes,
                     const void* out_codes, const void* stream_pos,
                     const void* is_out, const void* scale_in,
                     const void* scale_out, void* partial, void* y, int M,
                     int K, int N, int splits, int k_per_split,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_colstrip<__nv_bfloat16>(x, in_codes, out_codes, stream_pos,
                                          is_out, scale_in, scale_out,
                                          partial, y, M, K, N, splits,
                                          k_per_split, s);
  return launch_colstrip<float>(x, in_codes, out_codes, stream_pos, is_out,
                                scale_in, scale_out, partial, y, M, K, N,
                                splits, k_per_split, s);
}

const char* qmc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
