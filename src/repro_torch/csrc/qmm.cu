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
//   * decode (replaces qmm_pallas / _qmm_kernel): memory at M <= 8. Every
//     code byte (K*N of them) is read once, 2*M FLOPs per byte; at the
//     padded M = 8 the fp32 FMAs (8 per byte, 67 TFLOP/s) come close
//     behind the bytes (3.35 TB/s), so the products must stay off the
//     slow pipes. One launch per call, block = (128-column strip, 8-row
//     M tile, K split), 8 warps. The block first issues every global read
//     of its set-up at once: its slice of x (16-byte loads, widened to
//     fp32 into shared memory; rows unpadded, as every x read in the
//     products is a broadcast), the strip's scales and its subtile rows'
//     stream entries ((stream_pos << 1) | is_out, read once into shared
//     memory). A 3-stage cp.async ring of whole subtiles follows (8 per
//     stage, one per warp: 1 KB of the owning stream as 64 16-byte
//     copies; one barrier per stage); each lane reads its 4 columns of a
//     subtile row as one conflict-free word. Codes stay raw: a byte
//     permute and one subtraction make them floats (no int-to-float
//     instruction), and they go into an inlier or an outlier accumulator
//     chosen per subtile (warp-uniform); scale_in / scale_out multiply
//     the two per column at the end. x rows that are zero in the block's
//     slice (M is padded to 8 with zero rows) are skipped: the products
//     run at 1, 2, 4 or 8 rows, with no change to any result. N/128
//     strips is only 16 blocks at N = 2048, so K is split
//     (kernels/qmm.py:decode_splits, about two blocks per SM); each split
//     block writes its partial tile and takes a ticket on its (strip, M
//     tile) counter (release/acquire, no float atomics), and the block
//     with the last ticket adds the partials in split order 0..S-1, so
//     the result does not depend on which block came last (bit-identical
//     from run to run), writes y and resets the counter to 0.
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
//     split over blocks (an fp32 workspace and a second pass that adds
//     the partials in split order); kernels/qmm.py:colstrip_splits picks
//     the split by rounds of resident blocks (two per SM) times K steps
//     per block, which also evens out the last round (M = 512, N = 5632:
//     352 tiles x 3 splits = 4 full rounds of 264).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB_R = 8;
constexpr int SUB_C = 128;
constexpr int SUB_ELEMS = SUB_R * SUB_C;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
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

// ---------------------------------------------------------------------------
// decode width: block = (128-column strip, 8-row M tile, K split), one warp
// per subtile of a ring stage
// ---------------------------------------------------------------------------
constexpr int DEC_WARPS = 8;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_M = 8;                  // x rows per block
constexpr int DEC_P = DEC_WARPS;          // subtiles per ring stage
constexpr int DEC_STAGES = 3;
constexpr int DEC_MAX_ROWS = 256;         // kernels/qmm.py:DECODE_MAX_ROWS
constexpr int DEC_STAGE_BYTES = DEC_P * SUB_ELEMS;
constexpr int DEC_RING_BYTES = DEC_STAGES * DEC_STAGE_BYTES;
// the warps' partial tiles reuse the ring once the loop is done
constexpr int DEC_RED_BYTES = DEC_WARPS * DEC_M * SUB_C * 4;
constexpr int DEC_HEAD_BYTES =
    DEC_RING_BYTES > DEC_RED_BYTES ? DEC_RING_BYTES : DEC_RED_BYTES;
// 16-byte chunks of x a thread loads per x row, at most
template <typename T> __host__ __device__ constexpr int dec_xch() {
  return (DEC_MAX_ROWS * SUB_R * (int)sizeof(T) / 16 + DEC_THREADS - 1) /
         DEC_THREADS;
}

// ring | x slice (DEC_M rows of rows_per_split * 8 fp32) | scale_in,
// scale_out of the strip | stream entries of the block's subtile rows
int dec_smem_bytes(int rows_per_split) {
  return DEC_HEAD_BYTES + DEC_M * rows_per_split * SUB_R * 4 +
         2 * SUB_C * 4 + rows_per_split * 4;
}

// acc[m][j] += x[m][k0 + r] * code[r][j] over the 8 rows of one subtile,
// for the first MR x rows (the others are zero in this block's slice):
// w[r] holds the lane's 4 codes of row r, xk points at x[0][k0] in shared
// memory (row pitch kx floats). Each half subtile loads 4 x values of
// every row (broadcast float4s) and then runs row by row, so 4 * MR
// independent sums lie between two dependent FMAs.
template <int MR>
__device__ __forceinline__ void dec_subtile(float (&acc)[DEC_M][4],
                                            const uint32_t (&w)[SUB_R],
                                            const float* xk, int kx) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float4 xv[MR];
#pragma unroll
    for (int mm = 0; mm < MR; ++mm)
      xv[mm] = *reinterpret_cast<const float4*>(xk + mm * kx + 4 * h);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = __uint_as_float(cs_code(w[4 * h + r], j));
#pragma unroll
      for (int mm = 0; mm < MR; ++mm) {
        const float xr = r == 0 ? xv[mm].x : r == 1 ? xv[mm].y
                       : r == 2 ? xv[mm].z : xv[mm].w;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mm][j] = fmaf(xr, c[j], acc[mm][j]);
      }
    }
  }
}

// the subtile into the accumulator of its stream, at the block's live
// row count (1, 2, 4 or 8; block-uniform)
__device__ __forceinline__ void dec_subtile_any(float (&acc)[DEC_M][4],
                                                const uint32_t (&w)[SUB_R],
                                                const float* xk, int kx,
                                                int mr) {
  if (mr > 4)
    dec_subtile<8>(acc, w, xk, kx);
  else if (mr > 2)
    dec_subtile<4>(acc, w, xk, kx);
  else if (mr > 1)
    dec_subtile<2>(acc, w, xk, kx);
  else
    dec_subtile<1>(acc, w, xk, kx);
}

// the x values of one 16-byte chunk (4 fp32 or 8 bf16) as fp32
__device__ __forceinline__ void dec_x_store(float* d, uint4 w, float) {
  *reinterpret_cast<uint4*>(d) = w;
}
__device__ __forceinline__ void dec_x_store(float* d, uint4 w,
                                            __nv_bfloat16) {
  float4* f = reinterpret_cast<float4*>(d);
  f[0] = make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
  f[1] = make_float4(__uint_as_float(w.z << 16),
                     __uint_as_float(w.z & 0xffff0000u),
                     __uint_as_float(w.w << 16),
                     __uint_as_float(w.w & 0xffff0000u));
}

template <typename T>
__device__ __forceinline__ void dec_store(T* y, float4 v);
template <> __device__ __forceinline__ void dec_store<float>(float* y,
                                                             float4 v) {
  *reinterpret_cast<float4*>(y) = v;
}
template <> __device__ __forceinline__ void dec_store<__nv_bfloat16>(
    __nv_bfloat16* y, float4 v) {
  __nv_bfloat162 lo, hi;
  lo.x = from_f32<__nv_bfloat16>(v.x);
  lo.y = from_f32<__nv_bfloat16>(v.y);
  hi.x = from_f32<__nv_bfloat16>(v.z);
  hi.y = from_f32<__nv_bfloat16>(v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(y) = u;
}

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS, 2)
qmm_decode_kernel(const T* __restrict__ x, const int8_t* __restrict__ in_codes,
                  const int8_t* __restrict__ out_codes,
                  const int32_t* __restrict__ stream_pos,
                  const uint8_t* __restrict__ is_out,
                  const float* __restrict__ scale_in,
                  const float* __restrict__ scale_out,
                  float* __restrict__ partial, int* __restrict__ counters,
                  T* __restrict__ y, int M, int K, int N,
                  int rows_per_split) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  __shared__ unsigned live_rows[DEC_WARPS];
  __shared__ int last;
  const int strip = blockIdx.x;
  const int m0 = blockIdx.y * DEC_M;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int gc = N / SUB_C;
  const int g0 = split * rows_per_split;
  const int rows = min(K / SUB_R, g0 + rows_per_split) - g0;
  const int kx = rows * SUB_R;  // x columns of this block: xs row pitch
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* xs = reinterpret_cast<float*>(dec_smem + DEC_HEAD_BYTES);
  float* sc = xs + DEC_M * rows_per_split * SUB_R;  // scale_in | scale_out
  int* tag = reinterpret_cast<int*>(sc + 2 * SUB_C);
  const T* xg = x + (size_t)m0 * K + (size_t)g0 * SUB_R;

  // Every global read of the set-up is issued before any waits on one:
  // x in 16-byte loads to registers, the strip's scales (one per thread)
  // and the stream entries.
  constexpr int XCH = dec_xch<T>();
  constexpr int VPC = 16 / (int)sizeof(T);  // x values per chunk
  const int nch = kx / VPC;                 // chunks per x row
  uint4 xb[DEC_M][XCH];
#pragma unroll
  for (int mm = 0; mm < DEC_M; ++mm)
#pragma unroll
    for (int q = 0; q < XCH; ++q) {
      const int c = tid + q * DEC_THREADS;
      if (c < nch)
        xb[mm][q] = __ldg(reinterpret_cast<const uint4*>(
                              xg + (size_t)mm * K) + c);
    }
  static_assert(DEC_THREADS == 2 * SUB_C, "one scale per thread");
  const float scale = tid < SUB_C ? __ldg(scale_in + strip * SUB_C + tid)
                                  : __ldg(scale_out + strip * SUB_C + tid -
                                          SUB_C);
  // the strip's stream entries for this K range, read once:
  // (stream_pos << 1) | is_out per subtile row
  for (int i = tid; i < rows; i += DEC_THREADS) {
    const int t = (g0 + i) * gc + strip;
    tag[i] = (stream_pos[t] << 1) | (is_out[t] ? 1 : 0);
  }
  // x into shared memory as fp32, and which of its rows hold a nonzero
  // bit anywhere in this slice (M is padded with zero rows; the products
  // of the others are skipped, which changes no result)
  sc[tid] = scale;
  unsigned nz = 0;
#pragma unroll
  for (int mm = 0; mm < DEC_M; ++mm)
#pragma unroll
    for (int q = 0; q < XCH; ++q) {
      const int c = tid + q * DEC_THREADS;
      if (c < nch) {
        const uint4 w = xb[mm][q];
        dec_x_store(xs + mm * kx + c * VPC, w, T());
        if (w.x | w.y | w.z | w.w) nz |= 1u << mm;
      }
    }
  nz = __reduce_or_sync(0xffffffffu, nz);
  if (lane == 0) live_rows[warp] = nz;
  __syncthreads();
  unsigned live = 0;
#pragma unroll
  for (int w = 0; w < DEC_WARPS; ++w) live |= live_rows[w];
  const int mr = 32 - __clz(live);  // x rows up to the last live one

  // ring stage s: subtiles s * DEC_P + [0, DEC_P), 64 copies of 16 bytes
  // each, from the stream that owns it
  const int n_stages = (rows + DEC_P - 1) / DEC_P;
  auto load = [&](int s) {
    unsigned char* st = dec_smem + (s % DEC_STAGES) * DEC_STAGE_BYTES;
#pragma unroll
    for (int c = tid; c < DEC_P * 64; c += DEC_THREADS) {
      const int i = s * DEC_P + (c >> 6);
      if (i < rows) {
        const int e = tag[i];
        cs_cp16(st + c * 16, ((e & 1) ? out_codes : in_codes) +
                                 (size_t)(e >> 1) * SUB_ELEMS + (c & 63) * 16);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < DEC_STAGES - 1; ++s) {
    if (s < n_stages) load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // inlier and outlier code sums; the scales multiply them at the end
  float acc_in[DEC_M][4], acc_out[DEC_M][4];
#pragma unroll
  for (int mm = 0; mm < DEC_M; ++mm)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_in[mm][j] = acc_out[mm][j] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(DEC_STAGES - 2) : "memory");
    __syncthreads();  // stage s landed; the stage refilled below is free
    if (s + DEC_STAGES - 1 < n_stages) load(s + DEC_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int i = s * DEC_P + warp;  // the warp's subtile of the stage
    if (i < rows) {
      // lane's 4 columns of each subtile row: one conflict-free word
      const unsigned char* sub =
          dec_smem + (s % DEC_STAGES) * DEC_STAGE_BYTES + warp * SUB_ELEMS;
      uint32_t w[SUB_R];
#pragma unroll
      for (int r = 0; r < SUB_R; ++r)
        w[r] = *reinterpret_cast<const uint32_t*>(sub + r * SUB_C + lane * 4);
      if (tag[i] & 1)  // warp-uniform: one subtile of one stream
        dec_subtile_any(acc_out, w, xs + i * SUB_R, kx, mr);
      else
        dec_subtile_any(acc_in, w, xs + i * SUB_R, kx, mr);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // every warp is done with the ring

  // the warps' scaled partial tiles, then their sum in warp order: thread
  // tid owns row tid / 32, columns 4 * (tid % 32) + [0, 4) of the tile
  float4* red = reinterpret_cast<float4*>(dec_smem);
  {
    const float4 si = reinterpret_cast<const float4*>(sc)[lane];
    const float4 so = reinterpret_cast<const float4*>(sc + SUB_C)[lane];
#pragma unroll
    for (int mm = 0; mm < DEC_M; ++mm)
      red[(warp * DEC_M + mm) * 32 + lane] = make_float4(
          si.x * acc_in[mm][0] + so.x * acc_out[mm][0],
          si.y * acc_in[mm][1] + so.y * acc_out[mm][1],
          si.z * acc_in[mm][2] + so.z * acc_out[mm][2],
          si.w * acc_in[mm][3] + so.w * acc_out[mm][3]);
  }
  __syncthreads();
  static_assert(DEC_THREADS == DEC_M * 32, "one float4 of the tile each");
  const int mm = tid >> 5;
  float4 v = red[mm * 32 + lane];
#pragma unroll
  for (int w = 1; w < DEC_WARPS; ++w) {
    const float4 p = red[(w * DEC_M + mm) * 32 + lane];
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  const size_t at = (size_t)(m0 + mm) * N + strip * SUB_C + lane * 4;
  if (splits == 1) {
    dec_store<T>(y + at, v);
    return;
  }

  // K split: every block writes its partial tile; the block that takes the
  // last ticket of its (strip, M tile) adds all of them in split order 0..
  // splits-1 (its own read back too), so the sum does not depend on which
  // block came last, writes y and resets the counter for the next call
  const size_t mn = (size_t)M * N;
  __stcg(reinterpret_cast<float4*>(partial + split * mn + at), v);
  __syncthreads();  // the block's partial tile precedes thread 0's release
  int* counter = counters + blockIdx.y * gridDim.x + strip;
  if (tid == 0) {
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(ticket) : "l"(counter) : "memory");
    last = ticket == splits - 1;
  }
  __syncthreads();  // and thread 0's acquire precedes the block's reads
  if (!last) return;
  v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int sp = 0; sp < splits; ++sp) {
    const float4 p = __ldcg(reinterpret_cast<const float4*>(partial +
                                                            sp * mn + at));
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  dec_store<T>(y + at, v);
  if (tid == 0) *counter = 0;
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
                  void* counters, void* y, int M, int K, int N, int splits,
                  int rows_per_split, cudaStream_t stream) {
  const int smem = dec_smem_bytes(rows_per_split);
  // above 48 KB a block's shared memory needs the opt-in, once per type
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        qmm_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  dim3 grid(N / SUB_C, M / DEC_M, splits);
  qmm_decode_kernel<T><<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(in_codes),
      static_cast<const int8_t*>(out_codes),
      static_cast<const int32_t*>(stream_pos),
      static_cast<const uint8_t*>(is_out),
      static_cast<const float*>(scale_in),
      static_cast<const float*>(scale_out), static_cast<float*>(partial),
      static_cast<int*>(counters), static_cast<T*>(y), M, K, N,
      rows_per_split);
  return (int)cudaGetLastError();
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

// Does nothing: chip_smoke.py times its launch with the same timer as the
// kernels, as the floor under any one-launch call.
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int qmc_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// x_bf16 selects the activation type (0: fp32, 1: bf16); y has x's type.
// M a multiple of 8, K and N of 128, rows_per_split in [1, 256] subtile
// rows (else cudaErrorInvalidValue); x and the streams 16-byte aligned.
// With splits > 1, partial is an fp32 workspace of splits * M * N and
// counters a zeroed int32 buffer of (N / 128) * (M / 8), left zeroed; with
// splits == 1 neither is read. Returns cudaGetLastError().
int qmc_qmm_decode(const void* x, int x_bf16, const void* in_codes,
                   const void* out_codes, const void* stream_pos,
                   const void* is_out, const void* scale_in,
                   const void* scale_out, void* partial, void* counters,
                   void* y, int M, int K, int N, int splits,
                   int rows_per_split, void* stream) {
  // x is staged in registers sized for DEC_MAX_ROWS subtile rows
  if (rows_per_split < 1 || rows_per_split > DEC_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_decode<__nv_bfloat16>(x, in_codes, out_codes, stream_pos,
                                        is_out, scale_in, scale_out, partial,
                                        counters, y, M, K, N, splits,
                                        rows_per_split, s);
  return launch_decode<float>(x, in_codes, out_codes, stream_pos, is_out,
                              scale_in, scale_out, partial, counters, y, M,
                              K, N, splits, rows_per_split, s);
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
