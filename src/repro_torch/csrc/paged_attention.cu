// Ragged paged attention straight off the paged KV arena, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/paged_attention.py:
// ragged_paged_attention / _ragged_call (body _accumulate). Lane b's S
// queries sit at absolute positions q_start[b] + t and attend the pages
// block_tbl[b, p] causally, bounded by kv_len[b]; optional sliding window
// and tanh softcap; GQA (G = H / KV query rows share one KV head); int8
// pages are dequantized with per-(page slot, head) bf16 scales; online
// softmax one page at a time. Rows at positions >= kv_len come out exactly
// 0. Outputs o plus the softmax state (m, l) of every row.
//
// Block = (lane b, KV head h, q block qb of q_blk query tokens x G rows).
// The TPU grid's page axis becomes a loop inside the block that stops at
// the block's causal limit, ceil(min(kv_len, q_start + (qb+1)*q_blk) /
// page) pages: only causally live pages are read. Per page the block
// stages K and V of its head in shared memory, computes the R x page
// scores, masks them exactly as _accumulate does (masked probabilities
// forced to 0), updates the running (m, l) per row and rescales the
// accumulator, which lives in registers (R * hd <= 4096 at 128 threads).
//
// What bounds it on an H100: memory. Decode (S = 1) does ~4 FLOPs per
// K/V byte read; a prefill chunk reuses each page for up to q_blk * G
// rows, still far below the fp32 ridge. The design reads each live page of
// a head once per q block; tensor cores, a pipelined page ring (cp.async
// or TMA) and splitting long sequences over blocks are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PA_THREADS = 128;
constexpr int PA_ACC = 32;  // accumulator slots per thread: R * hd <= 4096

__global__ void __launch_bounds__(PA_THREADS)
ragged_paged_attention_kernel(
    const float* __restrict__ q, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const int32_t* __restrict__ tbl,
    const int32_t* __restrict__ q_start, const int32_t* __restrict__ kv_len,
    float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, int S_pad, int H, int KV, int hd, int page,
    int P, int q_blk, int window, float softcap, float scale,
    int quantized) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, qb = blockIdx.z;
  const int G = H / KV;
  const int R = q_blk * G;
  float* q_s = smem;              // [R][hd], pre-scaled
  float* k_s = q_s + R * hd;      // [page][hd]
  float* v_s = k_s + page * hd;   // [page][hd]
  float* p_s = v_s + page * hd;   // [R][page] scores, then probabilities
  float* m_s = p_s + R * page;    // [R]
  float* l_s = m_s + R;           // [R]
  float* c_s = l_s + R;           // [R] rescale factor of this page

  const int tid = threadIdx.x;
  const int kl = kv_len[b];
  const int qs = q_start[b];
  const int q0 = qs + qb * q_blk;  // position of the block's first token
  const int row0 = b * S_pad + qb * q_blk;  // first token row of q / o
  const int kvd = KV * hd;

  for (int i = tid; i < R * hd; i += PA_THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int tok = r / G, gg = r - tok * G;
    q_s[i] = q[((size_t)(row0 + tok) * H + h * G + gg) * hd + d] * scale;
  }
  for (int r = tid; r < R; r += PA_THREADS) {
    m_s[r] = -1e30f;
    l_s[r] = 0.f;
  }
  float acc[PA_ACC];
#pragma unroll
  for (int j = 0; j < PA_ACC; ++j) acc[j] = 0.f;

  int n_live = 0;
  if (q0 < kl) {
    const int limit = min(kl, qs + (qb + 1) * q_blk);
    n_live = (limit + page - 1) / page;
  }
  __syncthreads();

  for (int p = 0; p < n_live; ++p) {
    const size_t pid = (size_t)tbl[(size_t)b * P + p];
    for (int i = tid; i < page * hd; i += PA_THREADS) {
      const int t = i / hd, d = i - t * hd;
      const size_t off = (pid * page + t) * kvd + (size_t)h * hd + d;
      if (quantized) {
        const size_t so = (pid * page + t) * KV + h;
        k_s[i] = (float)static_cast<const int8_t*>(k_pages)[off] *
                 __bfloat162float(k_scale[so]);
        v_s[i] = (float)static_cast<const int8_t*>(v_pages)[off] *
                 __bfloat162float(v_scale[so]);
      } else {
        k_s[i] = static_cast<const float*>(k_pages)[off];
        v_s[i] = static_cast<const float*>(v_pages)[off];
      }
    }
    __syncthreads();
    for (int i = tid; i < R * page; i += PA_THREADS) {
      const int r = i / page, t = i - r * page;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(q_s[r * hd + d], k_s[t * hd + d], s);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int pos_q = q0 + r / G;
      const int pos_k = p * page + t;
      const bool ok = pos_k <= pos_q && pos_k < kl && pos_q < kl &&
                      (window <= 0 || pos_q - pos_k < window);
      p_s[i] = ok ? s : -INFINITY;  // -inf marks a masked entry
    }
    __syncthreads();
    for (int r = tid; r < R; r += PA_THREADS) {
      float cm = -1e30f;  // masked scores count as -1e30
      for (int t = 0; t < page; ++t) cm = fmaxf(cm, p_s[r * page + t]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, cm);
      float lsum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float s = p_s[r * page + t];
        const float pr = (s == -INFINITY) ? 0.f : expf(s - m_new);
        p_s[r * page + t] = pr;
        lsum += pr;
      }
      const float corr = expf(m_old - m_new);
      l_s[r] = l_s[r] * corr + lsum;
      m_s[r] = m_new;
      c_s[r] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PA_ACC; ++j) {
      const int i = tid + j * PA_THREADS;
      if (i < R * hd) {
        const int r = i / hd, d = i - r * hd;
        float a = acc[j] * c_s[r];
        for (int t = 0; t < page; ++t)
          a = fmaf(p_s[r * page + t], v_s[t * hd + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PA_ACC; ++j) {
    const int i = tid + j * PA_THREADS;
    if (i < R * hd) {
      const int r = i / hd, d = i - r * hd;
      const int tok = r / G, gg = r - tok * G;
      // a row with no live position keeps l == 0 -> output exactly 0
      o[((size_t)(row0 + tok) * H + h * G + gg) * hd + d] =
          acc[j] / fmaxf(l_s[r], 1e-30f);
    }
  }
  for (int r = tid; r < R; r += PA_THREADS) {
    const int tok = r / G, gg = r - tok * G;
    const size_t ml = (size_t)(row0 + tok) * H + h * G + gg;
    m_out[ml] = m_s[r];
    l_out[ml] = l_s[r];
  }
}

}  // namespace

extern "C" {

// Shared memory bytes the kernel needs for one block (the wrapper checks
// it against the 48 KB a block may use without opting in).
int qmc_ragged_paged_attention_smem(int R, int hd, int page) {
  return (int)sizeof(float) * (R * hd + 2 * page * hd + R * page + 3 * R);
}

// q [B, S_pad, H, hd] fp32 (S_pad a multiple of q_blk); k/v pages
// [n_pages, page, KV*hd] fp32, or int8 with bf16 scales [n_pages, page, KV];
// tbl [B, P] int32; q_start / kv_len [B] int32. o [B, S_pad, H, hd] and
// m / l [B, S_pad, H] fp32. window <= 0 and softcap <= 0 mean off.
// Returns cudaGetLastError().
int qmc_ragged_paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* k_scale,
                               const void* v_scale, const void* tbl,
                               const void* q_start, const void* kv_len,
                               void* o, void* m, void* l, int B, int S_pad,
                               int H, int KV, int hd, int page, int P,
                               int q_blk, int window, float softcap,
                               float scale, int quantized, void* stream) {
  const int R = q_blk * (H / KV);
  const int smem = qmc_ragged_paged_attention_smem(R, hd, page);
  dim3 grid(B, KV, S_pad / q_blk);
  ragged_paged_attention_kernel<<<grid, PA_THREADS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), k_pages, v_pages,
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int32_t*>(tbl), static_cast<const int32_t*>(q_start),
      static_cast<const int32_t*>(kv_len), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), S_pad, H, KV, hd, page,
      P, q_blk, window, softcap, scale, quantized);
  return (int)cudaGetLastError();
}

}  // extern "C"
