// Ragged paged attention, decode path (S = 1), for Hopper (sm_90a): one
// block per (span, lane * KV head); each warp takes one 16-key tile of a
// ring stage. Two kernels:
//   * attn_decode_kernel (fp32 q, or fp32 / int8 pages): the lanes split
//     hd (hd/32 dims each), with warp-shuffle dot products. hd 80 runs on
//     the hd-96 tiling (3 dims a lane) with dims 80-95 dead: their q is 0,
//     and they load and store nothing.
//   * attn_decode_bf16_kernel (bf16 q over bf16 pages, the bf16-mma
//     route): the G <= 8 query rows are rows 0-7 of one 16-row m tile
//     (rows 8-15 zero, mma16_top) and the tile's QK^T and PV run on
//     mma.sync m16n8k16 with the chunk route's fragment helpers: q's A
//     fragments straight from device memory into registers once per span,
//     K by ldmatrix, p as bf16 hi + lo against V by ldmatrix.trans.
// The kernel templates live here; paged_attention_decode.cu, _i8.cu and
// _bf16.cu instantiate them for fp32, int8 and bf16 pages, and their
// _sliced.cu over a page slice, one unit each, so that they compile in
// parallel. Design note: paged_attention.cu.
#pragma once
#include "paged_attention.cuh"

namespace qmc_pa {
namespace {

// element i of a K/V row in the ring, as fp32
template <int KIND>
__device__ __forceinline__ float elem(const unsigned char* row, int i) {
  if (KIND == KIND_I8) return i8_float(row[i], 0);
  if (KIND == KIND_BF16) return bf16_at(row, i);
  return reinterpret_cast<const float*>(row)[i];
}

// the same, 0 for the dead dims past HD of hd 80's hd-96 tiling (PAD);
// the other head dims compile to elem alone
template <int KIND, int HD, bool PAD>
__device__ __forceinline__ float elem_live(const unsigned char* row, int i) {
  if constexpr (PAD)
    return i < HD ? elem<KIND>(row, i) : 0.f;
  else
    return elem<KIND>(row, i);
}

// ---------------------------------------------------------------------------
// decode path (S = 1): warps over 16-key tiles, lanes over hd
// ---------------------------------------------------------------------------
// a warp per 16-key tile of a ring stage: 4, or 2 at 32-key stages
template <int KIND, int HD>
__host__ __device__ constexpr int dec_threads() {
  return stage_keys(HD, KIND) / KEY_TILE * 32;
}

// GM >= G rows, DPL = ceil(HD / 32) dims a lane; SLICED: a page slice
template <int KIND, int GM, int DPL, int HD, bool SLICED>
__global__ void __launch_bounds__(dec_threads<KIND, HD>())
attn_decode_kernel(Args a) {
  constexpr bool QUANT = KIND == KIND_I8;
  constexpr bool PAD = HD != DPL * 32;  // lanes' dims past HD are dead
  constexpr int TILES = dec_threads<KIND, HD>() / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.H / a.KV;  // rows (q_blk = 1)
  Span s;
  if (!span_of<SLICED>(a, G, s)) return;

  const Layout L = layout(HD, KIND, GM, TILES, a.span_pages, a.stages,
                          false, false);
  int* tbl_s = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + L.tbl;
  const int tid = threadIdx.x;
  load_span_table<SLICED>(a, s, tbl_s);
  __syncthreads();
  for (int st = 0; st < a.stages - 1; ++st) {
    if (st < s.n_stages)
      load_stage<KIND, HD>(a, ring + st * L.stage, L, tbl_s, st * L.keys,
                           s.n_keys, s.h);
    cp_commit();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int d0 = lane * DPL;
  float q[GM][DPL], acc[GM][DPL], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      bool has = g < G;
      if constexpr (PAD) has = has && d0 + i < HD;
      q[g][i] = has ? q_at(a, out_row(a, s.b, s.h, s.qb, g) * HD + d0 + i) *
                          a.scale
                    : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = NEG;
    l[g] = 0.f;
  }

  for (int st = 0; st < s.n_stages; ++st) {
    if (a.stages == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    const int nx = st + a.stages - 1;
    if (nx < s.n_stages)
      load_stage<KIND, HD>(a, ring + (nx % a.stages) * L.stage, L, tbl_s,
                           nx * L.keys, s.n_keys, s.h);
    cp_commit();

    const unsigned char* stg = ring + (st % a.stages) * L.stage;
    const int key0 = st * L.keys;
    const int kb = warp * KEY_TILE;
    if (key0 + kb >= s.n_keys) continue;
    const int kpos = s.p0 * a.page + key0 + kb;
    float ksc[KEY_TILE], vsc[KEY_TILE];
    if (QUANT) {
#pragma unroll
      for (int j = 0; j < KEY_TILE; ++j) {
        ksc[j] = stage_scale(a, stg, L, tbl_s, key0, kb + j, 0, s.h);
        vsc[j] = stage_scale(a, stg, L, tbl_s, key0, kb + j, 1, s.h);
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float sv[KEY_TILE];
      float cm = NEG;
#pragma unroll
      for (int j = 0; j < KEY_TILE; ++j) {
        const unsigned char* kr = stg + (kb + j) * L.k_row;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const float kv = elem_live<KIND, HD, PAD>(kr, d0 + i);
          part = fmaf(q[g][i], kv, part);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (QUANT) part *= ksc[j];
        if (a.softcap > 0.f) part = a.softcap * tanhf(part / a.softcap);
        sv[j] = visible(a, s.q0, kpos + j, s.kl) ? part : -INFINITY;
        cm = fmaxf(cm, sv[j]);
      }
      const float mn = fmaxf(m[g], cm);
      const float c = expf(m[g] - mn);
      m[g] = mn;
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= c;
#pragma unroll
      for (int j = 0; j < KEY_TILE; ++j) {
        const float p = sv[j] == -INFINITY ? 0.f : expf(sv[j] - mn);
        ps += p;
        const float pv = QUANT ? p * vsc[j] : p;
        const unsigned char* vr =
            stg + L.keys * L.k_row + (kb + j) * L.v_row;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const float vv = elem_live<KIND, HD, PAD>(vr, d0 + i);
          acc[g][i] = fmaf(pv, vv, acc[g][i]);
        }
      }
      l[g] = l[g] * c + ps;
    }
  }
  cp_wait<0>();
  __syncthreads();

  float* scratch = reinterpret_cast<float*>(ring);
  constexpr int SS = HD + 2;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    float* sr = scratch + ((size_t)warp * GM + g) * SS;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      if constexpr (PAD)
        if (d0 + i >= HD) continue;
      sr[d0 + i] = acc[g][i];
    }
    if (lane == 0) {
      sr[HD] = m[g];
      sr[HD + 1] = l[g];
    }
  }
  __syncthreads();
  epilogue(a, scratch, TILES, G, GM, s.b, s.h, s.qb, s.sp, s.n_sp);
}

// ---------------------------------------------------------------------------
// decode path, bf16 q over bf16 pages: one m16n8k16 m tile of G rows
// ---------------------------------------------------------------------------
template <int HD, bool SLICED>
__global__ void __launch_bounds__(dec_threads<KIND_BF16, HD>())
attn_decode_bf16_kernel(Args a) {
  constexpr int KS = HD / 16;  // 16-dim k steps (QK^T) / d tiles (PV)
  constexpr int NT = HD / 8;   // 8-dim n tiles of the accumulators
  constexpr int TILES = dec_threads<KIND_BF16, HD>() / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.H / a.KV;  // rows (q_blk = 1)
  // the rows of the warps' states in scratch (Geometry's rows_pad)
  const int gm = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
  Span s;
  if (!span_of<SLICED>(a, G, s)) return;

  const Layout L = layout(HD, KIND_BF16, gm, TILES, a.span_pages, a.stages,
                          false, false);
  int* tbl_s = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + L.tbl;
  const int tid = threadIdx.x;
  load_span_table<SLICED>(a, s, tbl_s);
  __syncthreads();
  for (int st = 0; st < a.stages - 1; ++st) {
    if (st < s.n_stages)
      load_stage<KIND_BF16, HD>(a, ring + st * L.stage, L, tbl_s,
                                st * L.keys, s.n_keys, s.h);
    cp_commit();
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  // row g's A fragment (a0: dims 16 ks + 2 tig .. + 1, a2: 8 further),
  // rows 8-15 zero; lanes of rows g >= G hold 0
  uint32_t qa[KS][2];
  {
    const uint32_t* qrow = static_cast<const uint32_t*>(a.q) +
        out_row(a, s.b, s.h, s.qb, g < G ? g : 0) * (HD / 2);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = g < G ? qrow[ks * 8 + tig] : 0u;
      qa[ks][1] = g < G ? qrow[ks * 8 + 4 + tig] : 0u;
    }
  }
  // this lane's ldmatrix rows in a stage (as the chunk route's)
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * L.k_row +
                    ((lane >> 3) & 1) * 16;
  const int v_off = L.keys * L.k_row + (lane & 15) * L.v_row +
                    (lane >> 4) * 16;
  float acc[NT][2], m = NEG, l = 0.f;  // row g's state
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = 0.f;

  for (int st = 0; st < s.n_stages; ++st) {
    if (a.stages == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    const int nx = st + a.stages - 1;
    if (nx < s.n_stages)
      load_stage<KIND_BF16, HD>(a, ring + (nx % a.stages) * L.stage, L,
                                tbl_s, nx * L.keys, s.n_keys, s.h);
    cp_commit();

    const unsigned char* stg = ring + (st % a.stages) * L.stage;
    const int key0 = st * L.keys;
    const int kb = warp * KEY_TILE;
    if (key0 + kb >= s.n_keys) continue;
    const int kpos = s.p0 * a.page + key0 + kb;
    // ---- row g's scores of keys 8j + 2tig .. + 1 ---------------------------
    float sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    const unsigned char* k_lane = stg + kb * L.k_row + k_off;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kf[4];
      ldsm4(kf, k_lane + ks * 32);
      mma16_top(sc[0], qa[ks][0], qa[ks][1], kf[0], kf[1]);
      mma16_top(sc[1], qa[ks][0], qa[ks][1], kf[2], kf[3]);
    }
    float cm = NEG;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = sc[j][e] * a.scale;
        if (a.softcap > 0.f) v = a.softcap * tanhf(v / a.softcap);
        const bool ok = visible(a, s.q0, kpos + 8 * j + 2 * tig + e, s.kl);
        sc[j][e] = ok ? v : -INFINITY;
        cm = fmaxf(cm, sc[j][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, off));
    const float mn = fmaxf(m, cm);
    const float c = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = sc[j][e] == -INFINITY ? 0.f : expf(sc[j][e] - mn);
        sc[j][e] = p;
        ps += p;
      }
    l = l * c + ps;  // lane-partial sum; the quad adds them at the end
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= c;
      acc[nt][1] *= c;
    }
    // ---- acc += p V: p as bf16 hi + lo, rows 8-15 zero --------------------
    uint32_t ph0, pl0, ph2, pl2;
    split_bf16(sc[0][0], sc[0][1], ph0, pl0);
    split_bf16(sc[1][0], sc[1][1], ph2, pl2);
    const unsigned char* v_lane = stg + kb * L.v_row + v_off;
#pragma unroll
    for (int dt = 0; dt < KS; ++dt) {
      uint32_t vf[4];
      ldsm4_t(vf, v_lane + dt * 32);
      mma16_top(acc[2 * dt], pl0, pl2, vf[0], vf[1]);
      mma16_top(acc[2 * dt], ph0, ph2, vf[0], vf[1]);
      mma16_top(acc[2 * dt + 1], pl0, pl2, vf[2], vf[3]);
      mma16_top(acc[2 * dt + 1], ph0, ph2, vf[2], vf[3]);
    }
  }
  cp_wait<0>();
  __syncthreads();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  float* scratch = reinterpret_cast<float*>(ring);
  constexpr int SS = HD + 2;
  if (g < G) {
    float* sr = scratch + ((size_t)warp * gm + g) * SS;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sr[nt * 8 + 2 * tig] = acc[nt][0];
      sr[nt * 8 + 2 * tig + 1] = acc[nt][1];
    }
    if (tig == 0) {
      sr[HD] = m;
      sr[HD + 1] = l;
    }
  }
  __syncthreads();
  epilogue(a, scratch, TILES, G, gm, s.b, s.h, s.qb, s.sp, s.n_sp);
}

// the bf16-mma route's decode kernels (bf16 q over bf16 pages); G <= 8
// rows fill one m tile whatever G is, so one instantiation per hd
template <bool SLICED>
int launch_decode_bf16_mma(dim3 grid, int smem, const Args& a,
                           cudaStream_t st) {
  if (a.H / a.KV > 8) return (int)cudaErrorInvalidValue;
  switch (a.hd) {
    case 32: return launch<attn_decode_bf16_kernel<32, SLICED>>(grid, dec_threads<KIND_BF16, 32>(), smem, a, st);
    case 64: return launch<attn_decode_bf16_kernel<64, SLICED>>(grid, dec_threads<KIND_BF16, 64>(), smem, a, st);
    case 80: return launch<attn_decode_bf16_kernel<80, SLICED>>(grid, dec_threads<KIND_BF16, 80>(), smem, a, st);
    case 128: return launch<attn_decode_bf16_kernel<128, SLICED>>(grid, dec_threads<KIND_BF16, 128>(), smem, a, st);
    case 256: return launch<attn_decode_bf16_kernel<256, SLICED>>(grid, dec_threads<KIND_BF16, 256>(), smem, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int KIND, int GM, bool SLICED>
int launch_decode(dim3 grid, int smem, const Args& a, cudaStream_t st) {
  switch (a.hd) {
    case 32: return launch<attn_decode_kernel<KIND, GM, 1, 32, SLICED>>(grid, dec_threads<KIND, 32>(), smem, a, st);
    case 64: return launch<attn_decode_kernel<KIND, GM, 2, 64, SLICED>>(grid, dec_threads<KIND, 64>(), smem, a, st);
    case 80: return launch<attn_decode_kernel<KIND, GM, 3, 80, SLICED>>(grid, dec_threads<KIND, 80>(), smem, a, st);
    case 128: return launch<attn_decode_kernel<KIND, GM, 4, 128, SLICED>>(grid, dec_threads<KIND, 128>(), smem, a, st);
    case 256: return launch<attn_decode_kernel<KIND, GM, 8, 256, SLICED>>(grid, dec_threads<KIND, 256>(), smem, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// rows G = H / KV picks the register tile GM >= G
template <int KIND, bool SLICED>
int launch_decode_kind(dim3 grid, int smem, const Args& a, cudaStream_t st) {
  const int G = a.H / a.KV;
  if (G <= 1) return launch_decode<KIND, 1, SLICED>(grid, smem, a, st);
  if (G <= 2) return launch_decode<KIND, 2, SLICED>(grid, smem, a, st);
  if (G <= 4) return launch_decode<KIND, 4, SLICED>(grid, smem, a, st);
  if (G <= 8) return launch_decode<KIND, 8, SLICED>(grid, smem, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace qmc_pa
