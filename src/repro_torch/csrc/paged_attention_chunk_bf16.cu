// Ragged paged attention, chunk path, bf16 q over bf16 pages: the bf16-mma
// route (mma.sync m16n8k16 bf16, fp32 accumulate), both slicings, hd 32,
// 64, 80, 128 and 256 (a unit of its own, compiled beside the others).
//
// Each warp owns one 16-row m tile of the q block and a group of 16-key
// tiles of each ring stage, as on the TF32 route (paged_attention.cu), and
// takes all its tiles of a stage at once (NP of them), so that their
// product and softmax chains interleave:
//   * QK^T: one m16n8k16 per 16 dims and 8 keys. q stays bf16 and
//     unscaled (its A fragments are loaded from shared memory once per
//     span, or once per 16 dims and pass at hd 256, where holding them
//     beside the 128 accumulators would spill); K fragments come by
//     ldmatrix. A bf16 product is exact in fp32, so the score is the fp32
//     sum of exact products; the softmax scale and the softcap apply to it.
//   * The softmax runs in log2 units (scores times log2 e, p = exp2(score
//     - m)); each row's visible keys are a range [lo, hi] fixed before the
//     walk (row_keys), so a mask is two compares; m goes back to natural
//     units for the outputs.
//   * PV: the score C fragments of a tile's two n8 tiles are PV's A
//     fragment as they stand. p is split into bf16 hi + lo (split_bf16:
//     |p - hi - lo| <= 2^-18 p), two m16n8k16 per 16 keys and 8 dims,
//     against V fragments loaded by ldmatrix.trans from the ring.
//   * The ring's rows keep the 16 bytes of padding of the other routes
//     (k_row = v_row = 2 hd + 16, q rows likewise): 8 rows of an 8x8
//     ldmatrix then start 4 banks apart (mod 32) and the loads are
//     conflict-free; no swizzle. The ring has two stages (smem_bytes):
//     the spans of a chunk are short and wait on latency, so more blocks
//     an SM beat a deeper ring.
// Design note: paged_attention.cu.
#include "paged_attention.cuh"

namespace qmc_pa {
namespace {

// NP: the 16-key tiles a warp takes at once (its tiles of a stage: 1 at
// G = 1, 2 at two m tiles, 4 from three; 2 at most at hd 256)
template <int HD, int NP, bool SLICED>
__global__ void __launch_bounds__(MAX_THREADS)
attn_chunk_bf16_kernel(Args a) {
  constexpr int KS = HD / 16;        // 16-dim k steps (QK^T) / d tiles (PV)
  constexpr int NT = HD / 8;         // 8-dim n tiles of the accumulators
  constexpr bool HOLD_Q = HD <= 128;  // q's A fragments in registers
  constexpr int QS = 2 * HD + 16;    // bytes per q row in shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.H / a.KV;
  const int rows = a.q_blk * G;
  const int MT = (rows + 15) / 16;
  const int rows_pad = MT * 16;
  const int n_warps = blockDim.x >> 5;
  const int groups = n_warps / MT;
  Span s;
  if (!span_of<SLICED>(a, rows, s)) return;

  const Layout L = layout(HD, KIND_BF16, rows_pad, groups, a.span_pages,
                          a.stages, true, true);
  constexpr int TILES = stage_keys(HD, KIND_BF16) / KEY_TILE;
  int* tbl_s = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + L.tbl;
  unsigned char* q_s = ring + (L.ring > L.scratch ? L.ring : L.scratch);

  const int tid = threadIdx.x;
  // q rows (bf16, as given) land with the first stage; padding rows are
  // zero-filled
  for (int i = tid; i < rows_pad * (HD / 8); i += blockDim.x) {
    const int r = i / (HD / 8), c = i - r * (HD / 8);
    const unsigned char* src = static_cast<const unsigned char*>(a.q);
    if (r < rows) src += (out_row(a, s.b, s.h, s.qb, r) * HD + c * 8) * 2;
    cp16(q_s + r * QS + c * 16, src, r < rows ? 16 : 0);
  }
  load_span_table<SLICED>(a, s, tbl_s);
  __syncthreads();

  for (int st = 0; st < a.stages - 1; ++st) {
    if (st < s.n_stages)
      load_stage<KIND_BF16, HD>(a, ring + st * L.stage, L, tbl_s,
                                st * L.keys, s.n_keys, s.h);
    cp_commit();
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int mt = warp % MT, grp = warp / MT;
  const int r0 = mt * 16 + g, r1 = r0 + 8;
  // the keys rows r0 and r1 see: [lo, hi] (empty for padding rows and
  // rows at or past kv_len), the rule of visible()
  int lo0, hi0, lo1, hi1;
  row_keys(a, r0 < rows, s.q0 + r0 / G, s.kl, lo0, hi0);
  row_keys(a, r1 < rows, s.q0 + r1 / G, s.kl, lo1, hi1);
  // this lane's ldmatrix rows: q's A (row l % 16, dims 8 (l / 16) on),
  // K's B (key l % 8 + 8 (l / 16), dims 8 (l / 8 % 2) on; registers: keys
  // 0-7 dims 0-7, 0-7 8-15, 8-15 0-7, 8-15 8-15) and V's B, transposed
  // (key l % 16, dims 8 (l / 16) on; registers: keys 0-7 and 8-15 of
  // dims 0-7, then of dims 8-15)
  const unsigned char* q_lane = q_s + (mt * 16 + (lane & 15)) * QS +
                                (lane >> 4) * 16;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * L.k_row +
                    ((lane >> 3) & 1) * 16;
  const int v_off = L.keys * L.k_row + (lane & 15) * L.v_row +
                    (lane >> 4) * 16;
  // scores in log2 units: s * scale * log2(e), or under a softcap c,
  // c * tanh(s * scale / c) * log2(e); p = exp2(score - m)
  const float sc_mul = a.softcap > 0.f ? a.scale / a.softcap
                                       : a.scale * LOG2E;
  const float cap_mul = a.softcap * LOG2E;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // m in log2 units
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  uint32_t qa[HOLD_Q ? KS : 1][4];
  // the warp's 16-key tiles of a stage, kt = grp + i * groups for i <
  // per_warp, taken NP at a time so that their chains interleave
  const int per_warp = TILES / groups;

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
    if (HOLD_Q && st == 0) {
#pragma unroll
      for (int ks = 0; ks < (HOLD_Q ? KS : 0); ++ks)
        ldsm4(qa[ks], q_lane + ks * 32);
    }

    const unsigned char* stg = ring + (st % a.stages) * L.stage;
    const int key0 = st * L.keys;
    const int kpos0 = s.p0 * a.page + key0;  // position of stage key 0
    for (int i0 = 0; i0 < per_warp; i0 += NP) {
      int kb[NP];  // stage-local first key of each tile
      bool on[NP];
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        kb[t] = (grp + (i0 + t) * groups) * KEY_TILE;
        on[t] = i0 + t < per_warp && key0 + kb[t] < s.n_keys;
      }
      if (!on[0]) break;
      // ---- S = q K^T (16 rows x 16 keys a tile; n8 tiles j = keys 8j..)
      float sc[NP][2][4];
#pragma unroll
      for (int t = 0; t < NP; ++t)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[t][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t af[4];
        if constexpr (HOLD_Q) {
#pragma unroll
          for (int i = 0; i < 4; ++i) af[i] = qa[ks][i];
        } else {
          ldsm4(af, q_lane + ks * 32);
        }
#pragma unroll
        for (int t = 0; t < NP; ++t) {
          if (!on[t]) continue;
          uint32_t kf[4];
          ldsm4(kf, stg + kb[t] * L.k_row + k_off + ks * 32);
          mma16(sc[t][0], af, kf[0], kf[1]);
          mma16(sc[t][1], af, kf[2], kf[3]);
        }
      }
      // ---- scale, softcap, mask, online softmax (rows r0, r1) ----------
      float cm0 = NEG, cm1 = NEG;
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        if (!on[t]) continue;  // (warp-uniform)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pos = kpos0 + kb[t] + 8 * j + 2 * tig + (e & 1);
            float v = sc[t][j][e] * sc_mul;
            if (a.softcap > 0.f) v = cap_mul * tanhf(v);
            const bool ok = e < 2 ? pos >= lo0 && pos <= hi0
                                  : pos >= lo1 && pos <= hi1;
            sc[t][j][e] = ok ? v : -INFINITY;
            if (e < 2)
              cm0 = fmaxf(cm0, sc[t][j][e]);
            else
              cm1 = fmaxf(cm1, sc[t][j][e]);
          }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        cm0 = fmaxf(cm0, __shfl_xor_sync(0xffffffffu, cm0, off));
        cm1 = fmaxf(cm1, __shfl_xor_sync(0xffffffffu, cm1, off));
      }
      const float mn0 = fmaxf(m0, cm0), mn1 = fmaxf(m1, cm1);
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        if (!on[t]) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // exp2(-inf) = +0: masked keys give exactly 0
            const float p = exp2f(sc[t][j][e] - (e < 2 ? mn0 : mn1));
            sc[t][j][e] = p;
            if (e < 2)
              ps0 += p;
            else
              ps1 += p;
          }
      }
      l0 = l0 * c0 + ps0;  // lane-partial sums; the quad adds them at the end
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] *= c0;
        acc[nt][1] *= c0;
        acc[nt][2] *= c1;
        acc[nt][3] *= c1;
      }
      // ---- acc += P V: the score fragments are the A fragment ----------
      // (a0: row g keys 2tig.., a1: row g + 8, a2 / a3: keys 8 + 2tig..)
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        if (!on[t]) continue;
        uint32_t ph[4], pl[4];
        split_bf16(sc[t][0][0], sc[t][0][1], ph[0], pl[0]);
        split_bf16(sc[t][0][2], sc[t][0][3], ph[1], pl[1]);
        split_bf16(sc[t][1][0], sc[t][1][1], ph[2], pl[2]);
        split_bf16(sc[t][1][2], sc[t][1][3], ph[3], pl[3]);
        const unsigned char* v_lane = stg + kb[t] * L.v_row + v_off;
#pragma unroll
        for (int dt = 0; dt < KS; ++dt) {
          uint32_t vf[4];
          ldsm4_t(vf, v_lane + dt * 32);
          mma16(acc[2 * dt], pl, vf[0], vf[1]);
          mma16(acc[2 * dt], ph, vf[0], vf[1]);
          mma16(acc[2 * dt + 1], pl, vf[2], vf[3]);
          mma16(acc[2 * dt + 1], ph, vf[2], vf[3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is drained: reuse it as scratch

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  float* scratch = reinterpret_cast<float*>(ring);
  constexpr int SS = HD + 2;
  float* s0 = scratch + ((size_t)grp * rows_pad + r0) * SS;
  float* s1 = scratch + ((size_t)grp * rows_pad + r1) * SS;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int d = nt * 8 + 2 * tig;
    s0[d] = acc[nt][0];
    s0[d + 1] = acc[nt][1];
    s1[d] = acc[nt][2];
    s1[d + 1] = acc[nt][3];
  }
  if (tig == 0) {  // m back in natural units (a row with no key: -1e30)
    s0[HD] = m0 == NEG ? NEG : m0 * LN2;
    s0[HD + 1] = l0;
    s1[HD] = m1 == NEG ? NEG : m1 * LN2;
    s1[HD + 1] = l1;
  }
  __syncthreads();
  epilogue(a, scratch, groups, rows, rows_pad, s.b, s.h, s.qb, s.sp, s.n_sp);
}

template <int NP, bool SLICED>
int launch_chunk_bf16_hd(dim3 grid, int threads, int smem, const Args& a,
                         cudaStream_t st) {
  switch (a.hd) {
    case 32: return launch<attn_chunk_bf16_kernel<32, NP, SLICED>>(grid, threads, smem, a, st);
    case 64: return launch<attn_chunk_bf16_kernel<64, NP, SLICED>>(grid, threads, smem, a, st);
    case 80: return launch<attn_chunk_bf16_kernel<80, NP, SLICED>>(grid, threads, smem, a, st);
    case 128: return launch<attn_chunk_bf16_kernel<128, NP, SLICED>>(grid, threads, smem, a, st);
    case 256: return launch<attn_chunk_bf16_kernel<256, NP < 2 ? NP : 2, SLICED>>(grid, threads, smem, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool SLICED>
int launch_chunk_bf16_np(dim3 grid, int threads, int smem, const Args& a,
                         cudaStream_t st) {
  // a warp's tiles of a stage: TILES over the key groups of its m tile
  const int mt = (a.q_blk * (a.H / a.KV) + 15) / 16;
  const int per_warp = STAGE_KEYS / KEY_TILE / (threads / 32 / mt);
  switch (per_warp) {
    case 1: return launch_chunk_bf16_hd<1, SLICED>(grid, threads, smem, a, st);
    case 2: return launch_chunk_bf16_hd<2, SLICED>(grid, threads, smem, a, st);
    case 4: return launch_chunk_bf16_hd<4, SLICED>(grid, threads, smem, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

int launch_chunk_bf16(dim3 grid, int threads, int smem, const Args& a,
                      cudaStream_t st) {
  return a.sliced ? launch_chunk_bf16_np<true>(grid, threads, smem, a, st)
                  : launch_chunk_bf16_np<false>(grid, threads, smem, a, st);
}

}  // namespace qmc_pa
