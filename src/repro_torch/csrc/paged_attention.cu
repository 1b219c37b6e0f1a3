// Ragged paged attention straight off the paged KV arena, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/paged_attention.py:
// ragged_paged_attention / _ragged_call (body _accumulate). Lane b's S
// queries sit at absolute positions q_start[b] + t and attend the pages
// block_tbl[b, p] causally, bounded by kv_len[b]; optional sliding window
// and tanh softcap; GQA (G = H / KV query rows share one KV head); int8
// pages carry per-(page slot, head) bf16 scales; q may be fp32 or bf16 and
// the pages fp32, bf16 or int8, each widened to fp32 on the way into the
// product, as the reference casts them (paged_attention.py:118-121),
// except bf16 q over bf16 pages, whose products are bf16 tensor-core
// products (exact in fp32 for q K^T); online softmax. Rows at
// positions >= kv_len come out exactly 0. Outputs o plus the softmax state
// (m, l) of every row.
//
// What bounds it on an H100: memory latency and bytes. Decode (S = 1)
// does ~4 FLOPs per K/V byte; a 16-token q block reuses each page for
// 16 * G rows, still far below the ridge. So the design keeps many page
// reads in flight and spends little on the arithmetic:
//
//   * Split-KV (flash-decoding). The causally live pages of one (lane, KV
//     head, q block) -- ceil(min(kv_len, q_start + (qb+1)*q_blk) / page),
//     the bound the engine's prefill_kv_pages_live counter mirrors -- from
//     the window's first page on (first_page: max(0, q0 - window + 1) /
//     page for the block's first query q0, computed on the device, so a
//     graphed step stays one replay; page 0 without a window) are cut into
//     spans of span_pages pages (a multiple of one ring stage). Pages
//     wholly before the window are never read: the reference's masked
//     keys there add exactly 0.
//     grid = (span, lane * KV head, q block). A span block writes its
//     partial (o*l, m, l) to an fp32 workspace; a second pass merges the
//     spans of each row in span order (deterministic, no atomics) -- the
//     (o, m, l) merge of paged_attention.py:346-351. A (lane, head, q
//     block) with one span writes o, m, l directly and the merge skips it;
//     a dead q block (q_start + qb*q_blk >= kv_len) writes its zero rows
//     from span 0 and exits; spans past the live pages exit at once.
//   * A page ring in shared memory filled by cp.async (16-byte copies,
//     zero-filled past the span; the int8 scales as 4-byte words), 2 or 3
//     stages of 64 keys (32 where a page row is over 512 bytes, fp32 at
//     hd 256, so that two stages fit), so the next stages' K, V and scales
//     are in flight while this one is computed; one __syncthreads per
//     stage. The span's
//     block-table entries are read once into shared memory.
//   * Chunk path (q_blk = 16 tokens x G rows, padded to 16-row m tiles):
//     QK^T and PV on tensor cores, mma.sync m16n8k8 TF32. fp32 operands
//     are split into hi + lo TF32 parts and three products (hi*hi + hi*lo
//     + lo*hi) keep fp32 accuracy. int8 K is exact in TF32 and its scale
//     factors out of the dot (s = ks[t] * (q . k_int8[t])), so only q is
//     split; vs[t] is folded into p before PV, where p is split. bf16
//     pages under an fp32 q are exact in TF32 too (8 significant bits of
//     11): widened by a shift as they leave the ring, they take the int8
//     route's two products, with no scale. Each
//     warp owns one m tile and a group of 16-key tiles with its own
//     running (m, l, acc); the reduction index of QK^T is permuted so the
//     score fragment is PV's A fragment as it stands, and the shared
//     memory rows are padded so every fragment load is conflict-free.
//   * The bf16-mma route, bf16 q over bf16 pages (route_of; its own
//     chunk unit, paged_attention_chunk_bf16.cu, and decode kernel): q
//     stays bf16 and unscaled; QK^T takes one mma.sync m16n8k16 bf16 per
//     16 dims and 8 keys (exact products, fp32 sums; the scale and
//     softcap then apply to the fp32 score), PV two per 16 keys and 8
//     dims on p as bf16 hi + lo (2^-18 of p kept, where the reference
//     multiplies in fp32); K and V fragments come by ldmatrix (.trans for
//     V) off the same ring, whose 16-byte row padding keeps them
//     conflict-free. The chunk path's warps own m tiles and key groups as
//     on the TF32 route; the decode path puts the G <= 8 rows in one m
//     tile (rows G..15 zero) per 16-key warp tile.
//   * Decode path otherwise (S = 1, R = G rows): a 16-row mma tile would
//     be G/16 full, so each warp takes one 16-key tile of the stage and the
//     lanes split hd (hd/32 dims each; hd 80 runs as 96 with dims 80-95
//     dead: q 0, nothing loaded or stored); dots are warp-shuffle
//     reductions.
//   * The warps' softmax states are merged in warp order through shared
//     memory at the end of the span.
//   * A page slice (a data rank's part of the arena, on a mesh; JAX's
//     `meta`): table entries are global ids and only those in the slice
//     count. It is resolved where spans are planned: a span is a chunk of
//     span_pages of a run of consecutive live entries in the slice
//     (slice_chunks, ballots over the lane's table row), so the key
//     positions inside a span stay linear and the inner loops are the
//     unsliced ones. A row with no live page in the slice gives (0, -1e30,
//     0), which the cross-rank merge weighs 0. The slice is a template
//     switch (SLICED): the kernels of unsliced calls carry none of it.
//
// Sources: this file (chunk path, span merge, C entry points), the chunk
// path of the bf16-mma route in paged_attention_chunk_bf16.cu, the decode
// path's kernels in paged_attention_decode.cuh, instantiated for fp32,
// int8 and bf16 pages in paged_attention_decode.cu, _i8.cu and _bf16.cu
// (with the bf16-mma decode kernel) and, over a page slice, in their
// _sliced.cu (one unit per page kind and slicing, built in parallel: 16-21
// instantiations each), and paged_attention.cuh (what all share, the
// bf16 fragment helpers among it).
#include "paged_attention.cuh"

namespace qmc_pa {
namespace {

// ---------------------------------------------------------------------------
// chunk path: tensor cores, one m tile of 16 rows and a key group per warp
// ---------------------------------------------------------------------------
// NT = hd / 8 (4, 8, 10, 16 or 32); SLICED: a page slice
template <int KIND, int NT, bool SLICED>
__global__ void __launch_bounds__(MAX_THREADS)
attn_chunk_kernel(Args a) {
  constexpr bool QUANT = KIND == KIND_I8;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int HD = NT * 8;
  const int G = a.H / a.KV;
  const int rows = a.q_blk * G;
  const int MT = (rows + 15) / 16;
  const int rows_pad = MT * 16;
  const int n_warps = blockDim.x >> 5;
  const int groups = n_warps / MT;
  Span s;
  if (!span_of<SLICED>(a, rows, s)) return;

  const Layout L = layout(HD, KIND, rows_pad, groups, a.span_pages,
                          a.stages, true, false);
  constexpr int TILES = stage_keys(HD, KIND) / KEY_TILE;
  int* tbl_s = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + L.tbl;
  const int ring_or_scratch = L.ring > L.scratch ? L.ring : L.scratch;
  uint32_t* q_hi = reinterpret_cast<uint32_t*>(ring + ring_or_scratch);
  uint32_t* q_lo = q_hi + rows_pad * (HD + 8);
  constexpr int QS = HD + 8;

  const int tid = threadIdx.x;
  // fp32 q rows land in q_lo with the first stage (padding rows
  // zero-filled); they are scaled and split in place once that stage has
  // arrived. bf16 q is read then, straight from device memory.
  for (int i = tid; !a.q_bf16 && i < rows_pad * (HD / 4); i += blockDim.x) {
    const int r = i / (HD / 4), c = i - r * (HD / 4);
    const float* src = static_cast<const float*>(a.q);
    if (r < rows) src += out_row(a, s.b, s.h, s.qb, r) * HD + c * 4;
    cp16(q_lo + r * QS + c * 4, src, r < rows ? 16 : 0);
  }
  load_span_table<SLICED>(a, s, tbl_s);
  __syncthreads();

  for (int st = 0; st < a.stages - 1; ++st) {
    if (st < s.n_stages)
      load_stage<KIND, HD>(a, ring + st * L.stage, L, tbl_s, st * L.keys,
                           s.n_keys, s.h);
    cp_commit();
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int mt = warp % MT, grp = warp / MT;
  const int r0 = mt * 16 + g, r1 = r0 + 8;
  const int pq0 = r0 < rows ? s.q0 + r0 / G : 0x7fffffff;
  const int pq1 = r1 < rows ? s.q0 + r1 / G : 0x7fffffff;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

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

    if (st == 0) {  // q, pre-scaled, as TF32 hi + lo
      for (int i = tid; i < rows_pad * HD; i += blockDim.x) {
        const int r = i / HD, d = i - r * HD;
        float qv = __uint_as_float(q_lo[r * QS + d]);
        if (a.q_bf16)
          qv = r < rows ? q_at(a, out_row(a, s.b, s.h, s.qb, r) * HD + d)
                        : 0.f;
        uint32_t hi, lo;
        split(qv * a.scale, hi, lo);
        q_hi[r * QS + d] = hi;
        q_lo[r * QS + d] = lo;
      }
      __syncthreads();
    }
    const unsigned char* stg = ring + (st % a.stages) * L.stage;
    const int key0 = st * L.keys;
    for (int kt = grp; kt < TILES; kt += groups) {
      if (key0 + kt * KEY_TILE >= s.n_keys) break;
      const int kb = kt * KEY_TILE;  // stage-local first key of the tile
      // ---- S = q K^T (16 rows x 16 keys) ---------------------------------
      // one accumulator per product keeps the mma chains independent
      float sc[2][4], sx[2][4], sy[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = sx[j][e] = sy[j][e] = 0.f;
#pragma unroll 4
      for (int ks = 0; ks < NT; ++ks) {
        const int col = ks * 8 + 2 * tig;
        const uint2 h0 = *reinterpret_cast<const uint2*>(q_hi + r0 * QS + col);
        const uint2 h1 = *reinterpret_cast<const uint2*>(q_hi + r1 * QS + col);
        const uint2 w0 = *reinterpret_cast<const uint2*>(q_lo + r0 * QS + col);
        const uint2 w1 = *reinterpret_cast<const uint2*>(q_lo + r1 * QS + col);
        // reduction index k <-> dim: tig -> 2*tig, tig + 4 -> 2*tig + 1
        const uint32_t ah[4] = {h0.x, h1.x, h0.y, h1.y};
        const uint32_t al[4] = {w0.x, w1.x, w0.y, w1.y};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = kb + 8 * j + g;
          if (QUANT) {  // int8 K is exact in TF32
            const uint32_t kw = *reinterpret_cast<const uint16_t*>(
                stg + key * L.k_row + col);
            const uint32_t b0 = __float_as_uint(i8_float(kw, 0));
            const uint32_t b1 = __float_as_uint(i8_float(kw, 1));
            mma(sx[j], al, b0, b1);
            mma(sc[j], ah, b0, b1);
          } else if (KIND == KIND_BF16) {  // so is bf16 K
            const uint32_t kw = *reinterpret_cast<const uint32_t*>(
                stg + key * L.k_row + col * 2);
            mma(sx[j], al, kw << 16, kw & 0xffff0000u);
            mma(sc[j], ah, kw << 16, kw & 0xffff0000u);
          } else {
            const float2 kv = *reinterpret_cast<const float2*>(
                stg + key * L.k_row + col * 4);
            uint32_t b0h, b0l, b1h, b1l;
            split(kv.x, b0h, b0l);
            split(kv.y, b1h, b1l);
            mma(sy[j], al, b0h, b1h);
            mma(sx[j], ah, b0l, b1l);
            mma(sc[j], ah, b0h, b1h);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += sx[j][e] + sy[j][e];
      // ---- mask, softcap, online softmax (rows r0, r1) -------------------
      const int kpos = s.p0 * a.page + key0 + kb;  // position of key kb
      float cm0 = NEG, cm1 = NEG;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 8 * j + 2 * tig + (e & 1);  // key within the tile
          float v = sc[j][e];
          if (QUANT)
            v *= stage_scale(a, stg, L, tbl_s, key0, kb + kk, 0, s.h);
          if (a.softcap > 0.f) v = a.softcap * tanhf(v / a.softcap);
          const bool ok = visible(a, e < 2 ? pq0 : pq1, kpos + kk, s.kl);
          sc[j][e] = ok ? v : -INFINITY;
          if (e < 2)
            cm0 = fmaxf(cm0, sc[j][e]);
          else
            cm1 = fmaxf(cm1, sc[j][e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        cm0 = fmaxf(cm0, __shfl_xor_sync(0xffffffffu, cm0, off));
        cm1 = fmaxf(cm1, __shfl_xor_sync(0xffffffffu, cm1, off));
      }
      const float mn0 = fmaxf(m0, cm0), mn1 = fmaxf(m1, cm1);
      const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = sc[j][e];
          const float p = v == -INFINITY ? 0.f : expf(v - (e < 2 ? mn0 : mn1));
          sc[j][e] = p;
          if (e < 2)
            ps0 += p;
          else
            ps1 += p;
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
      // ---- acc += P V: the score fragment is the A fragment --------------
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ka = kb + 8 * j + 2 * tig;  // stage-local keys ka, ka + 1
        float p[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
        if (QUANT) {
          const float v0 = stage_scale(a, stg, L, tbl_s, key0, ka, 1, s.h);
          const float v1 = stage_scale(a, stg, L, tbl_s, key0, ka + 1, 1, s.h);
          p[0] *= v0;
          p[1] *= v0;
          p[2] *= v1;
          p[3] *= v1;
        }
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(p[e], ph[e], pl[e]);
        const unsigned char* v0r = stg + L.keys * L.k_row + ka * L.v_row;
        const unsigned char* v1r = v0r + L.v_row;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int d = nt * 8 + g;
          if (QUANT) {
            const uint32_t b0 = __float_as_uint(i8_float(v0r[d], 0));
            const uint32_t b1 = __float_as_uint(i8_float(v1r[d], 0));
            mma(acc[nt], pl, b0, b1);
            mma(acc[nt], ph, b0, b1);
          } else if (KIND == KIND_BF16) {
            const uint32_t b0 = __float_as_uint(bf16_at(v0r, d));
            const uint32_t b1 = __float_as_uint(bf16_at(v1r, d));
            mma(acc[nt], pl, b0, b1);
            mma(acc[nt], ph, b0, b1);
          } else {
            uint32_t b0h, b0l, b1h, b1l;
            split(reinterpret_cast<const float*>(v0r)[d], b0h, b0l);
            split(reinterpret_cast<const float*>(v1r)[d], b1h, b1l);
            mma(acc[nt], pl, b0h, b1h);
            mma(acc[nt], ph, b0l, b1l);
            mma(acc[nt], ph, b0h, b1h);
          }
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
  if (tig == 0) {
    s0[HD] = m0;
    s0[HD + 1] = l0;
    s1[HD] = m1;
    s1[HD + 1] = l1;
  }
  __syncthreads();
  epilogue(a, scratch, groups, rows, rows_pad, s.b, s.h, s.qb, s.sp, s.n_sp);
}

// ---------------------------------------------------------------------------
// second pass: merge the spans of every row in span order (one warp a row)
// ---------------------------------------------------------------------------
// (SLICED: a call over a page slice, whose spans are the chunks of runs;
// a compile-time switch, so the unsliced merge carries none of it)
template <bool SLICED>
__global__ void __launch_bounds__(128) attn_merge_kernel(Args a) {
  const size_t rows_total = (size_t)a.B * a.S_pad * a.H;
  const size_t row = (size_t)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows_total) return;
  const int b = (int)(row / ((size_t)a.S_pad * a.H));
  const int t = (int)((row / a.H) % a.S_pad);
  const int qb = t / a.q_blk;
  const int n_live = live_pages(a, b, qb);
  const int lo = n_live ? first_page(a, b, qb) : 0;
  int n_sp = (n_live - lo + a.span_pages - 1) / a.span_pages;
  if constexpr (SLICED) {
    int p0, len;
    n_sp = n_live ? slice_chunks(a, b, lo, n_live, -1, &p0, &len) : 0;
  }
  if (n_sp <= 1) return;  // written by its only span (or dead)
  float mx = NEG;
  for (int sp = 0; sp < n_sp; ++sp)
    mx = fmaxf(mx, a.pm[(size_t)sp * rows_total + row]);
  float lsum = 0.f;
  for (int sp = 0; sp < n_sp; ++sp) {
    const size_t pr = (size_t)sp * rows_total + row;
    lsum += a.pl[pr] * expf(a.pm[pr] - mx);
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  for (int d = lane; d < a.hd; d += 32) {
    float acc = 0.f;
    for (int sp = 0; sp < n_sp; ++sp) {
      const size_t pr = (size_t)sp * rows_total + row;
      acc += a.po[pr * a.hd + d] * expf(a.pm[pr] - mx);
    }
    a.o[row * a.hd + d] = acc * inv;
  }
  if (lane == 0) {
    a.m[row] = mx;
    a.l[row] = lsum;
  }
}

template <int KIND, bool SLICED>
int launch_chunk(dim3 grid, int threads, int smem, const Args& a,
                 cudaStream_t st) {
  switch (a.hd) {
    case 32: return launch<attn_chunk_kernel<KIND, 4, SLICED>>(grid, threads, smem, a, st);
    case 64: return launch<attn_chunk_kernel<KIND, 8, SLICED>>(grid, threads, smem, a, st);
    case 80: return launch<attn_chunk_kernel<KIND, 10, SLICED>>(grid, threads, smem, a, st);
    case 128: return launch<attn_chunk_kernel<KIND, 16, SLICED>>(grid, threads, smem, a, st);
    case 256: return launch<attn_chunk_kernel<KIND, 32, SLICED>>(grid, threads, smem, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool SLICED>
int launch_chunk_kind(dim3 grid, int threads, int smem, const Args& a,
                      cudaStream_t st) {
  switch (a.kind) {
    case KIND_F32: return launch_chunk<KIND_F32, SLICED>(grid, threads, smem, a, st);
    case KIND_I8: return launch_chunk<KIND_I8, SLICED>(grid, threads, smem, a, st);
    case KIND_BF16: return launch_chunk<KIND_BF16, SLICED>(grid, threads, smem, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_span(dim3 grid, int threads, int smem, const Args& a,
                cudaStream_t st) {
  if (a.q_blk > 1 && route_of(a.q_blk, a.q_bf16, a.kind) == ROUTE_BF16_MMA)
    return launch_chunk_bf16(grid, threads, smem, a, st);
  if (a.q_blk > 1)
    return a.sliced ? launch_chunk_kind<true>(grid, threads, smem, a, st)
                    : launch_chunk_kind<false>(grid, threads, smem, a, st);
  switch (a.kind * 2 + a.sliced) {
    case KIND_F32 * 2: return launch_decode_f32(grid, smem, a, st);
    case KIND_F32 * 2 + 1: return launch_decode_f32_sliced(grid, smem, a, st);
    case KIND_I8 * 2: return launch_decode_i8(grid, smem, a, st);
    case KIND_I8 * 2 + 1: return launch_decode_i8_sliced(grid, smem, a, st);
    case KIND_BF16 * 2: return launch_decode_bf16(grid, smem, a, st);
    case KIND_BF16 * 2 + 1: return launch_decode_bf16_sliced(grid, smem, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Block geometry of a call: threads, rows_pad (rows of the state), groups
// (warp key groups) and whether it takes the chunk path.
struct Geometry {
  int threads, rows_pad, groups;
  bool chunk;
};

Geometry geometry(int rows, int q_blk, int hd, int kind) {
  Geometry g;
  const int tiles = stage_keys(hd, kind) / KEY_TILE;
  g.chunk = q_blk > 1;
  if (!g.chunk) {
    g.rows_pad = rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : 8;
    g.groups = tiles;
    g.threads = tiles * 32;
    return g;
  }
  const int mt = (rows + 15) / 16;
  g.rows_pad = mt * 16;
  g.groups = (mt <= tiles && tiles % mt == 0) ? tiles / mt : 1;
  g.threads = mt * g.groups * 32;
  return g;
}

int smem_bytes(int rows, int q_blk, int hd, int kind, int span_pages,
               int q_bf16, int* stages) {
  const Geometry g = geometry(rows, q_blk, hd, kind);
  const bool mma16 = route_of(q_blk, q_bf16, kind) == ROUTE_BF16_MMA;
  // three stages while two blocks still fit on an SM, else two, decided on
  // fp32 q rows; the bf16-mma route's chunk kernel always takes two (more
  // blocks an SM: its short spans wait on latency, not on the ring), so it
  // never needs more bytes than the other routes
  for (int s = 3; s >= 2; --s) {
    const Layout L = layout(hd, kind, g.rows_pad, g.groups, span_pages, s,
                            g.chunk, false);
    if (s == 2 || (L.total <= 113 * 1024 && !(mma16 && g.chunk))) {
      *stages = s;
      return layout(hd, kind, g.rows_pad, g.groups, span_pages, s, g.chunk,
                    mma16).total;
    }
  }
  return 0;
}

}  // namespace
}  // namespace qmc_pa

using namespace qmc_pa;

extern "C" {

// Dynamic shared memory bytes one span block needs (R = q_blk * G rows).
// The wrapper checks it against the 227 KB a block may opt into.
// kind: 0 fp32 pages, 1 int8 pages with bf16 scales, 2 bf16 pages;
// q_bf16: q is bf16.
int qmc_ragged_paged_attention_smem(int R, int q_blk, int hd, int kind,
                                    int span_pages, int q_bf16) {
  int stages;
  return smem_bytes(R, q_blk, hd, kind, span_pages, q_bf16, &stages);
}

// The route a call takes (Route: 0 the chunk path's TF32 products, 1 bf16
// products of bf16 q over bf16 pages, 2 the decode path's shuffle dots).
int qmc_ragged_paged_attention_route(int q_blk, int q_bf16, int kind) {
  return route_of(q_blk, q_bf16, kind);
}

// q [B, S_pad, H, hd] fp32, or bf16 when q_bf16 (S_pad a multiple of
// q_blk); k/v pages [n_pages, page, KV*hd] fp32 (kind 0), int8 with bf16
// scales [n_pages, page, KV] (kind 1) or bf16 (kind 2);
// tbl [B, P] int32; q_start / kv_len [B] int32. o [B, S_pad, H, hd] and
// m / l [B, S_pad, H] fp32. window <= 0 and softcap <= 0 mean off. Spans
// of span_pages pages (a multiple of stage_keys(hd, kind) / page) cut from
// each q block's window floor (first_page), n_spans = ceil(W / span_pages)
// for W = P, or min(P, ceil((window + q_blk - 1) / page) + 1) under a
// window; with n_spans > 1, po / pm / pl are the fp32 workspace
// [n_spans, B, S_pad, H(, hd)]. slice_pages > 0: the pages hold the slice
// [slice_first, slice_first + slice_pages) of the global arena, table
// entries are global page ids and only those inside the slice are read
// (a row with none gives o 0, m -1e30, l 0), the spans are the chunks of
// span_pages of each run of consecutive entries in the slice, and n_spans
// bounds their count; slice_pages == 0: the entries are local ids.
// Returns cudaGetLastError().
int qmc_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* tbl,
    const void* q_start, const void* kv_len, void* o, void* m, void* l,
    void* po, void* pm, void* pl, int B, int S_pad, int H, int KV, int hd,
    int page, int P, int q_blk, int window, float softcap, float scale,
    int q_bf16, int kind, int span_pages, int n_spans, int slice_first,
    int slice_pages, void* stream) {
  if (kind < KIND_F32 || kind > KIND_BF16) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k_pages = static_cast<const unsigned char*>(k_pages);
  a.v_pages = static_cast<const unsigned char*>(v_pages);
  a.k_scale = static_cast<const unsigned char*>(k_scale);
  a.v_scale = static_cast<const unsigned char*>(v_scale);
  a.tbl = static_cast<const int32_t*>(tbl);
  a.q_start = static_cast<const int32_t*>(q_start);
  a.kv_len = static_cast<const int32_t*>(kv_len);
  a.o = static_cast<float*>(o);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.po = static_cast<float*>(po);
  a.pm = static_cast<float*>(pm);
  a.pl = static_cast<float*>(pl);
  a.B = B; a.S_pad = S_pad; a.H = H; a.KV = KV; a.hd = hd; a.page = page;
  a.P = P; a.q_blk = q_blk; a.window = window; a.softcap = softcap;
  a.scale = scale; a.q_bf16 = q_bf16; a.kind = kind;
  a.span_pages = span_pages;
  a.n_spans = n_spans;
  a.sliced = slice_pages > 0;
  a.slice_first = a.sliced ? slice_first : 0;
  a.slice_pages = slice_pages;
  const int rows = q_blk * (H / KV);
  const Geometry g = geometry(rows, q_blk, hd, kind);
  const int smem = smem_bytes(rows, q_blk, hd, kind, span_pages, q_bf16,
                              &a.stages);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_spans, B * KV, S_pad / q_blk);
  const int rc = launch_span(grid, g.threads, smem, a, st);
  if (rc != 0 || n_spans == 1) return rc;
  const size_t rows_total = (size_t)B * S_pad * H;
  const unsigned blocks = (unsigned)((rows_total + 3) / 4);
  if (a.sliced)
    attn_merge_kernel<true><<<blocks, 128, 0, st>>>(a);
  else
    attn_merge_kernel<false><<<blocks, 128, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
