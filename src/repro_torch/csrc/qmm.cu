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
//   * colstrip: arithmetic at M >= 128 (2*M FLOPs per code byte), so the
//     product runs on tensor cores: mma.sync m16n8k8 TF32 (wgmma with a
//     TMA ring is the full-rate route, later work). The weight side is
//     exact: codes are integers of at most 5 bits, exact in TF32, and one
//     8-deep k step covers exactly one subtile row of one stream (the
//     block's 128 columns are one strip), so the block stages the raw
//     codes, keeps two fp32 accumulators (inlier, outlier codes), picks
//     one per k step by is_out (block-uniform), and applies scale_in /
//     scale_out per column in the epilogue. x is then the only operand
//     that rounds: fp32 x is split into TF32 hi + lo, two products per k
//     step (one TF32 pass would round x to 2^-11, ~3e-4 max|y| at K =
//     2048, above the 1e-4 tolerance); bf16 x is exact in one pass. A
//     4-stage cp.async ring (16-byte copies) holds the 64 x 32 x tile and
//     the 32 code rows (128 contiguous bytes each) of a step; the strip's
//     is_out / stream_pos entries for the block's K range are read into
//     shared memory once. Block = 64 x 128 output tile, 8 warps of 32 x 32;
//     x rows are padded to 40 (fp32) / 20 (bf16) words and code rows to
//     144 bytes, and the reduction index is permuted so each lane loads
//     neighbouring values, which makes every fragment load conflict-free.
//     At N = 2048 and M = 128 there are only 32 output tiles, so K is
//     split over blocks (same workspace and fixed-order second pass as
//     decode); kernels/qmm.py:colstrip_splits picks the split by rounds of
//     resident blocks (two per SM) times K steps per block, which also
//     evens out the last round (M = 512, N = 5632: 352 tiles x 3 splits
//     = 4 full rounds of 264).
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
// column strip: block = one 64 x 128 output tile (one 128-wide strip),
// tensor cores (mma.sync m16n8k8 TF32) over the raw codes
// ---------------------------------------------------------------------------
constexpr int CS_BM = 64;
constexpr int CS_BN = SUB_C;  // one strip: every column shares is_out
constexpr int CS_BK = 32;     // 4 subtile rows per ring stage
constexpr int CS_STAGES = 4;
constexpr int CS_THREADS = 256;  // 8 warps: 2 (M) x 4 (N), 32 x 32 each
constexpr int CS_CODE_ROW = SUB_C + 16;  // bytes: conflict-free B loads

// bytes per x row in a stage: 32 values plus padding that makes the A
// fragment loads conflict-free (fp32: 40 words a row, bf16: 20)
template <typename T> __host__ __device__ constexpr int cs_x_row() {
  return sizeof(T) == 4 ? 160 : 80;
}
template <typename T> __host__ __device__ constexpr int cs_stage_bytes() {
  return CS_BM * cs_x_row<T>() + CS_BK * CS_CODE_ROW;
}
template <typename T> int cs_smem_bytes(int k_per_split) {
  return CS_STAGES * cs_stage_bytes<T>() + (k_per_split / SUB_R) * 4;
}

__device__ __forceinline__ void cs_cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
// byte j of w (an int8 code) as an exact float, without a conversion
// instruction: 2^23 + (code + 128) - (2^23 + 128)
__device__ __forceinline__ uint32_t cs_code(uint32_t w, int j) {
  return __float_as_uint(__uint_as_float(__byte_perm(w ^ 0x80808080u,
                                                     0x4b000000u, 0x7540 | j)) -
                         8388736.f);
}
__device__ __forceinline__ void cs_mma(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of one 8-deep k step for the warp's two m tiles. The
// reduction index is permuted (k = tig <-> 2*tig, tig + 4 <-> 2*tig + 1)
// so each lane reads two neighbouring x values at once. fp32 x is split
// into TF32 hi + lo (two products, |x - hi - lo| < 2^-20 |x|); bf16 x is
// exact in TF32 (lo unused).
template <typename T>
__device__ __forceinline__ void cs_a_frags(const unsigned char* xs, int kk,
                                           int wm0, int g, int tig,
                                           uint32_t (&hi)[2][4],
                                           uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float v[4];  // (g, 2tig), (g+8, 2tig), (g, 2tig+1), (g+8, 2tig+1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm0 + mt * 16 + g + 8 * h;
      if (sizeof(T) == 4) {
        const float2 p = *reinterpret_cast<const float2*>(
            xs + r * cs_x_row<T>() + (kk * 8 + 2 * tig) * 4);
        v[h] = p.x;
        v[h + 2] = p.y;
      } else {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            xs + r * cs_x_row<T>() + (kk * 8 + 2 * tig) * 2);
        v[h] = __uint_as_float(w << 16);
        v[h + 2] = __uint_as_float(w & 0xffff0000u);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (sizeof(T) == 4) {  // 11 significant bits each, cut by masking
        hi[mt][e] = __float_as_uint(v[e]) & 0xffffe000u;
        lo[mt][e] =
            __float_as_uint(v[e] - __uint_as_float(hi[mt][e])) & 0xffffe000u;
      } else {
        hi[mt][e] = __float_as_uint(v[e]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void cs_kstep(float (&acc)[2][4][4],
                                         const uint32_t (&hi)[2][4],
                                         const uint32_t (&lo)[2][4],
                                         const uint32_t (&b0)[4],
                                         const uint32_t (&b1)[4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (sizeof(T) == 4) cs_mma(acc[mt][j], lo[mt], b0[j], b1[j]);
      cs_mma(acc[mt][j], hi[mt], b0[j], b1[j]);
    }
}

template <typename T>
__global__ void __launch_bounds__(CS_THREADS, 2)
qmm_colstrip_kernel(const T* __restrict__ x,
                    const int8_t* __restrict__ in_codes,
                    const int8_t* __restrict__ out_codes,
                    const int32_t* __restrict__ stream_pos,
                    const uint8_t* __restrict__ is_out,
                    const float* __restrict__ scale_in,
                    const float* __restrict__ scale_out,
                    float* __restrict__ partial, T* __restrict__ y, int M,
                    int K, int N, int k_per_split) {
  extern __shared__ __align__(16) unsigned char cs_smem[];
  constexpr int STAGE = cs_stage_bytes<T>();
  constexpr int XROW = cs_x_row<T>();
  constexpr int XCH = 32 * (int)sizeof(T) / 16;  // 16-byte chunks per x row
  int* tag = reinterpret_cast<int*>(cs_smem + CS_STAGES * STAGE);

  const int strip = blockIdx.x;
  const int m0 = blockIdx.y * CS_BM;
  const int split = blockIdx.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_steps = (k_end - k_begin) / CS_BK;
  const int gc = N / SUB_C;
  const int tid = threadIdx.x;

  // the strip's stream entries for this K range, read once:
  // (stream_pos << 1) | is_out per subtile row
  const int gi0 = k_begin / SUB_R;
  for (int i = tid; i < (k_end - k_begin) / SUB_R; i += CS_THREADS) {
    const int t = (gi0 + i) * gc + strip;
    tag[i] = (stream_pos[t] << 1) | (is_out[t] ? 1 : 0);
  }
  __syncthreads();

  auto load = [&](int step) {
    unsigned char* st = cs_smem + (step % CS_STAGES) * STAGE;
    const int k0 = k_begin + step * CS_BK;
    for (int i = tid; i < CS_BM * XCH; i += CS_THREADS) {
      const int r = i / XCH, c = i - r * XCH;
      cs_cp16(st + r * XROW + c * 16,
              reinterpret_cast<const unsigned char*>(
                  x + (size_t)(m0 + r) * K + k0) + c * 16);
    }
    unsigned char* cs = st + CS_BM * XROW;
    const int r = tid >> 3, c = tid & 7;  // 32 code rows x 8 chunks
    const int e = tag[(k0 - k_begin + r) / SUB_R];
    const int8_t* base = (e & 1) ? out_codes : in_codes;
    cs_cp16(cs + r * CS_CODE_ROW + c * 16,
            base + (size_t)(e >> 1) * SUB_ELEMS + ((k0 + r) % SUB_R) * SUB_C +
                c * 16);
  };

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int wm0 = (warp >> 2) * 32;  // warp's first row in the tile
  const int wn0 = (warp & 3) * 32;   // warp's first column in the strip
  // two accumulators (inlier / outlier codes); scales in the epilogue.
  // n tile j, mma column n <-> strip column wn0 + 4n + j, so one 32-bit
  // load gives a lane its B values of all four n tiles
  float acc_in[2][4][4], acc_out[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_in[mt][j][e] = acc_out[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < CS_STAGES - 1; ++s) {
    if (s < n_steps) load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int step = 0; step < n_steps; ++step) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(CS_STAGES - 2) : "memory");
    __syncthreads();  // this stage landed; the stage refilled below is free
    if (step + CS_STAGES - 1 < n_steps) load(step + CS_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const unsigned char* xs = cs_smem + (step % CS_STAGES) * STAGE;
    const unsigned char* cs = xs + CS_BM * XROW;
    const int t0 = step * CS_BK / SUB_R;
#pragma unroll
    for (int kk = 0; kk < CS_BK / SUB_R; ++kk) {
      uint32_t hi[2][4], lo[2][4], b0[4], b1[4];
      cs_a_frags<T>(xs, kk, wm0, g, tig, hi, lo);
      const int kr = kk * 8 + 2 * tig;
      const uint32_t w0 =
          *reinterpret_cast<const uint32_t*>(cs + kr * CS_CODE_ROW + wn0 + 4 * g);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
          cs + (kr + 1) * CS_CODE_ROW + wn0 + 4 * g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // codes are exact in TF32
        b0[j] = cs_code(w0, j);
        b1[j] = cs_code(w1, j);
      }
      if (tag[t0 + kk] & 1)  // one subtile row of one stream: block-uniform
        cs_kstep<T>(acc_out, hi, lo, b0, b1);
      else
        cs_kstep<T>(acc_in, hi, lo, b0, b1);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // epilogue: y = s_in * acc_in + s_out * acc_out per column; lane holds
  // columns wn0 + 8 tig + [0, 8) of rows g, g + 8 of each m tile
  const int col0 = strip * SUB_C + wn0 + 8 * tig;
  float si[8], so[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    si[c] = scale_in[col0 + c];
    so[c] = scale_out[col0 + c];
  }
  float* part = partial ? partial + (size_t)split * M * N : nullptr;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm0 + mt * 16 + g + 8 * h;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = si[j] * acc_in[mt][j][2 * h] + so[j] * acc_out[mt][j][2 * h];
        v[4 + j] = si[4 + j] * acc_in[mt][j][2 * h + 1] +
                   so[4 + j] * acc_out[mt][j][2 * h + 1];
      }
      const size_t at = (size_t)r * N + col0;
      if (part) {
        float4* p = reinterpret_cast<float4*>(part + at);
        p[0] = make_float4(v[0], v[1], v[2], v[3]);
        p[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) y[at + c] = from_f32<T>(v[c]);
      }
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
  const int smem = cs_smem_bytes<T>(k_per_split);
  // above 48 KB a block's shared memory needs the opt-in, once per type
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        qmm_colstrip_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  dim3 grid(N / CS_BN, M / CS_BM, splits);
  qmm_colstrip_kernel<T><<<grid, CS_THREADS, smem, stream>>>(
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

// M a multiple of 64; k_per_split a multiple of 32; x 16-byte aligned;
// with splits == 1 partial is unused.
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
