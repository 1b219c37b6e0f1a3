// Shared pieces of the ragged paged-attention kernels (paged_attention.cu:
// the chunk path, the span merge and the C entry points;
// paged_attention_chunk_bf16.cu: the chunk path of bf16 q over bf16 pages;
// paged_attention_decode*.cu: the decode path). The design note is at the
// top of paged_attention.cu.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace qmc_pa {

constexpr int STAGE_KEYS = 64;  // keys per ring stage (stage_keys: 32 for
                                // rows over 512 bytes)
constexpr int KEY_TILE = 16;    // keys per warp work item
constexpr int MAX_THREADS = 256;
constexpr float NEG = -1e30f;  // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// What the K/V pages hold. fp32 pages are split into hi + lo TF32 parts on
// the chunk path; int8 codes (with bf16 scales) and bf16 values under an
// fp32 q are exact in TF32 and are widened to fp32 as they leave the ring;
// bf16 values under a bf16 q go to bf16 tensor-core products as they are.
enum Kind { KIND_F32 = 0, KIND_I8 = 1, KIND_BF16 = 2 };

// Which kernel family a call runs (route_of): the chunk path's TF32
// products, the bf16 products of bf16 q over bf16 pages (chunk and
// decode), or the decode path's warp-shuffle dots.
enum Route { ROUTE_TF32 = 0, ROUTE_BF16_MMA = 1, ROUTE_SHUFFLE = 2 };

__host__ __device__ inline int route_of(int q_blk, int q_bf16, int kind) {
  if (q_bf16 && kind == KIND_BF16) return ROUTE_BF16_MMA;
  return q_blk > 1 ? ROUTE_TF32 : ROUTE_SHUFFLE;
}

struct Args {
  const void* q;  // fp32, or bf16 when q_bf16 (widened as it is read)
  const unsigned char* k_pages;
  const unsigned char* v_pages;
  const unsigned char* k_scale;  // bf16 [n_pages, page, KV]
  const unsigned char* v_scale;
  const int32_t* tbl;
  const int32_t* q_start;
  const int32_t* kv_len;
  float* o;   // [B, S_pad, H, hd]
  float* m;   // [B, S_pad, H]
  float* l;
  float* po;  // [n_spans, B, S_pad, H, hd] partial o*l (n_spans > 1)
  float* pm;  // [n_spans, B, S_pad, H]
  float* pl;
  int B, S_pad, H, KV, hd, page, P, q_blk, window;
  float softcap, scale;
  int q_bf16, kind, span_pages, n_spans, stages;
  // the page slice [slice_first, slice_first + slice_pages) of the global
  // arena that the k/v pages hold (a data rank's, on a mesh): table entries
  // are global ids and those outside it contribute nothing. sliced == 0:
  // every entry is a local page (slice_first 0).
  int sliced, slice_first, slice_pages;
};

// ---- shared-memory layout (host and device agree) ------------------------
struct Layout {
  int keys;          // keys per stage
  int k_row, v_row;  // bytes per key row of K / V in a stage
  int stage;         // bytes per stage
  int tbl, ring, q, scratch, total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ constexpr int row_bytes(int hd, int kind) {
  return kind == KIND_I8 ? hd : kind == KIND_BF16 ? 2 * hd : 4 * hd;
}

// Keys per ring stage: 64, or 32 where a page row is over 512 bytes (fp32
// at hd 256), so that two stages of K and V fit a block's shared memory.
// kernels/paged_attention.py:stage_keys mirrors it.
__host__ __device__ constexpr int stage_keys(int hd, int kind) {
  return row_bytes(hd, kind) > 512 ? STAGE_KEYS / 2 : STAGE_KEYS;
}

// chunk: the chunk path, whose q rows sit beside the ring: fp32 hi + lo
// TF32 parts, or bf16 as given on the bf16-mma route (mma16).
__host__ __device__ inline Layout layout(int hd, int kind, int rows_pad,
                                         int groups, int span_pages,
                                         int stages, bool chunk,
                                         bool mma16) {
  Layout L;
  // 16 bytes of padding per row (fp32 K: 32) make the fragment loads
  // conflict-free (see the note in paged_attention.cu)
  const int rb = row_bytes(hd, kind);
  L.keys = stage_keys(hd, kind);
  L.k_row = kind == KIND_F32 ? rb + 32 : rb + 16;
  L.v_row = rb + 16;
  L.stage = L.keys * (L.k_row + L.v_row) +
            (kind == KIND_I8 ? 2 * 4 * L.keys : 0);
  L.tbl = align16(span_pages * 4);
  L.ring = stages * L.stage;
  L.q = !chunk ? 0
        : mma16 ? rows_pad * (hd + 8) * 2
                : 2 * rows_pad * (hd + 8) * 4;
  // the warps' final states, written over the ring once it is drained
  L.scratch = groups * rows_pad * (hd + 2) * 4;
  L.total = L.tbl + (L.ring > L.scratch ? L.ring : L.scratch) + L.q;
  return L;
}

// ---- PTX helpers -----------------------------------------------------------
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo + r, |r| < 2^-20 |x|: both parts keep 11 significant bits
// (valid TF32), cut by masking (full-rate logic, not conversions)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
// byte j of w (an int8) as an exact float: 2^23 + (x + 128) - (2^23 + 128)
__device__ __forceinline__ float i8_float(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4b000000u,
                                     0x7540 | j)) - 8388736.f;
}
// c += a * b, m16n8k8, TF32 inputs, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- bf16 tensor-core fragments (the bf16-mma route) ---------------------
// Four 8x8 b16 matrices from shared memory: lane l gives the address of a
// 16-byte row of matrix l / 8, and register i of lane l receives elements
// (l / 4, 2 (l % 4) .. + 1) of matrix i; .trans gives its transpose's.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* row) {
  const unsigned p = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* row) {
  const unsigned p = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p));
}
// c += a * b, m16n8k16, bf16 inputs, fp32 accumulate
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the same with rows 8-15 of a zero (a decode tile: G <= 8 rows): a0, a2
// are rows 0-7's fragments, c their two sums; rows 8-15's are dropped
__device__ __forceinline__ void mma16_top(float (&c)[2], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  float d2, d3;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(c[0]),
        "f"(c[1]), "f"(0.f), "f"(0.f));
}
// (x0, x1) as bf16 pairs hi + lo: hi their rounding, lo the rounding of
// the exact rest, so x = hi + lo + r with |r| <= 2^-18 |x|
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float bf16_half(uint32_t word, int odd) {
  const uint16_t bits = odd ? (uint16_t)(word >> 16) : (uint16_t)word;
  return __bfloat162float(__ushort_as_bfloat16(bits));
}
// element i of a bf16 row as an exact float (its bits, shifted up)
__device__ __forceinline__ float bf16_at(const unsigned char* row, int i) {
  return __uint_as_float(
      (uint32_t)reinterpret_cast<const uint16_t*>(row)[i] << 16);
}
// element i of q, widened to fp32 when q is bf16
__device__ __forceinline__ float q_at(const Args& a, size_t i) {
  if (a.q_bf16)
    return __uint_as_float(
        (uint32_t)static_cast<const uint16_t*>(a.q)[i] << 16);
  return static_cast<const float*>(a.q)[i];
}

// Live pages of (lane b, q block qb): 0 for a dead q block. The kernel and
// the merge pass both use it; kernels/paged_attention.py:span_plan mirrors it.
__device__ __forceinline__ int live_pages(const Args& a, int b, int qb) {
  const int kl = a.kv_len[b], qs = a.q_start[b];
  if (qs + qb * a.q_blk >= kl) return 0;
  const int limit = min(kl, qs + (qb + 1) * a.q_blk);
  return (limit + a.page - 1) / a.page;
}

// First page of the walk of (lane b, q block qb): the page of the first key
// its first query sees under the window, max(0, q0 - window + 1) / page
// (0 without a window). No row of the block sees a key below it, so the
// spans are cut from it to live_pages; the pages before it are never read.
// kernels/paged_attention.py:first_page mirrors it.
__device__ __forceinline__ int first_page(const Args& a, int b, int qb) {
  if (a.window <= 0) return 0;
  const int q0 = a.q_start[b] + qb * a.q_blk;
  return max(0, q0 - a.window + 1) / a.page;
}

// Whether table entry e lies in the slice.
__device__ __forceinline__ bool in_slice(const Args& a, int e) {
  return (unsigned)(e - a.slice_first) < (unsigned)a.slice_pages;
}

// The spans of a sliced call: lane b's table entries [lo, n) split into
// runs of consecutive entries in the slice, each run cut into chunks of
// span_pages pages from its start (so a span's pages are consecutive
// logical pages, all in the slice, and its key positions stay linear).
// Returns the number of chunks; chunk `want`, when it exists, starts at
// logical page *p0 and holds *len pages. Every lane of a warp calls it
// and gets the same answer (ballots over 32 entries at a time).
__device__ inline int slice_chunks(const Args& a, int b, int lo, int n,
                                   int want, int* p0, int* len) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const size_t row = (size_t)b * a.P;
  int count = 0, run = -1, first = -1, end = -1;
  for (int base = lo; base < n; base += 32) {
    const int p = base + lane;
    const bool in = p < n && in_slice(a, a.tbl[row + p]);
    const unsigned outs = ~__ballot_sync(0xffffffffu, in);
    // start of the run holding p: past the last entry out of the slice
    // below it in this word, else the run carried from the last word
    const unsigned o = outs & below;
    const int rs = o ? base + 32 - __clz(o) : (run >= 0 ? run : base);
    const bool start = in && (p - rs) % a.span_pages == 0;
    const unsigned starts = __ballot_sync(0xffffffffu, start);
    const unsigned hit = __ballot_sync(
        0xffffffffu, start && count + __popc(starts & below) == want);
    if (hit) first = base + __ffs(hit) - 1;
    if (first >= 0 && end < 0) {
      const unsigned e = outs & __ballot_sync(0xffffffffu, p > first);
      if (e) end = base + __ffs(e) - 1;
    }
    count += __popc(starts);
    run = outs >> 31 ? -1 : __shfl_sync(0xffffffffu, rs, 31);
  }
  if (first >= 0) {
    *p0 = first;
    *len = min(end < 0 ? n : end, first + a.span_pages) - first;
  }
  return count;
}

// Global row index of row r (= token * G + g) of (lane b, head h, block qb).
__device__ __forceinline__ size_t out_row(const Args& a, int b, int h, int qb,
                                          int r) {
  const int G = a.H / a.KV;
  const int tok = r / G, gg = r - tok * G;
  return ((size_t)b * a.S_pad + qb * a.q_blk + tok) * a.H + h * G + gg;
}

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

// One ring stage: keys [key0, key0 + L.keys) of the span (span-local),
// rows past key_end zero-filled. K/V rows are 16-byte chunks (a
// compile-time count: a shift at hd 2^k, a multiply-shift at hd 80's 5,
// 10 or 20); the scale of (page id, slot, head) travels as the aligned
// 4-byte word holding it. page is a power of two.
template <int KIND, int HD>
__device__ inline void load_stage(const Args& a, unsigned char* st,
                                  const Layout& L, const int* tbl_s, int key0,
                                  int key_end, int h) {
  constexpr int RB = row_bytes(HD, KIND);
  constexpr int CPR = RB / 16;  // 16-byte chunks per row
  const int p_log = ilog2(a.page);
  const int per = L.keys * CPR;  // chunks of K (then of V) in a stage
  unsigned char* ks = st;
  unsigned char* vs = st + L.keys * L.k_row;
  for (int i = threadIdx.x; i < 2 * per; i += blockDim.x) {
    const int which = i >= per;  // 0: K, 1: V
    const int j = which ? i - per : i;
    const int row = j / CPR, c = j - row * CPR;
    const int key = key0 + row;
    const bool ok = key < key_end;
    const unsigned char* base = which ? a.v_pages : a.k_pages;
    const unsigned char* src = base;
    if (ok) {
      const size_t r = ((size_t)tbl_s[key >> p_log] * a.page +
                        (key & (a.page - 1))) * a.KV + h;
      src = base + r * RB + c * 16;
    }
    unsigned char* dst =
        (which ? vs + row * L.v_row : ks + row * L.k_row) + c * 16;
    cp16(dst, src, ok ? 16 : 0);
  }
  if (KIND == KIND_I8) {
    uint32_t* sc = reinterpret_cast<uint32_t*>(
        st + L.keys * (L.k_row + L.v_row));
    for (int i = threadIdx.x; i < 2 * L.keys; i += blockDim.x) {
      const int which = i >= L.keys;
      const int key = key0 + (which ? i - L.keys : i);
      const bool ok = key < key_end;
      const unsigned char* base = which ? a.v_scale : a.k_scale;
      const unsigned char* src = base;
      if (ok) {
        const size_t e = ((size_t)tbl_s[key >> p_log] * a.page +
                          (key & (a.page - 1))) * a.KV + h;
        src = base + (e & ~(size_t)1) * 2;
      }
      cp4(sc + i, src, ok ? 4 : 0);
    }
  }
}

// Scale of span-local key `key` from its stage word (which: 0 K, 1 V).
__device__ __forceinline__ float stage_scale(const Args& a,
                                             const unsigned char* st,
                                             const Layout& L, const int* tbl_s,
                                             int key0, int row, int which,
                                             int h) {
  const uint32_t* sc =
      reinterpret_cast<const uint32_t*>(st + L.keys * (L.k_row + L.v_row));
  const int key = key0 + row;
  const size_t e = ((size_t)tbl_s[key >> ilog2(a.page)] * a.page +
                    (key & (a.page - 1))) * a.KV + h;
  return bf16_half(sc[which * L.keys + row], (int)(e & 1));
}

__device__ __forceinline__ bool visible(const Args& a, int pos_q, int pos_k,
                                        int kl) {
  return pos_k <= pos_q && pos_k < kl && pos_q < kl &&
         (a.window <= 0 || pos_q - pos_k < a.window);
}

// The keys a row at position pos_q sees, [lo, hi] (hi < lo: none): the
// rule of visible() as a range, for a row that exists (row) in a lane
// whose kv_len is kl.
__device__ __forceinline__ void row_keys(const Args& a, bool row, int pos_q,
                                         int kl, int& lo, int& hi) {
  if (!row || pos_q >= kl) {
    lo = 1;
    hi = 0;
    return;
  }
  hi = pos_q;
  lo = a.window > 0 ? pos_q - a.window + 1 : 0;
}

// The span's epilogue: merge the warps' states (groups in order) and write
// the final (o, m, l) (one span) or this span's partial. Each row's weights
// are computed once: rows' threads turn each group's m into its weight
// exp(m - max m) in place and write the row's (m, l), then every element
// sums its groups' partials.
__device__ inline void epilogue(const Args& a, float* scratch, int groups,
                                int rows, int rows_pad, int b, int h, int qb,
                                int sp, int n_sp) {
  const int hd = a.hd;
  const int stride = hd + 2;  // per row: hd accumulators, then m, l
  const size_t rows_total = (size_t)a.B * a.S_pad * a.H;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float mx = NEG;
    for (int gi = 0; gi < groups; ++gi)
      mx = fmaxf(mx, scratch[((size_t)gi * rows_pad + r) * stride + hd]);
    float lsum = 0.f;
    for (int gi = 0; gi < groups; ++gi) {
      float* s = scratch + ((size_t)gi * rows_pad + r) * stride;
      const float w = expf(s[hd] - mx);
      lsum += s[hd + 1] * w;
      s[hd] = w;
    }
    scratch[(size_t)r * stride + hd + 1] = lsum;  // group 0's l: read
    const size_t row = out_row(a, b, h, qb, r);
    if (n_sp == 1) {
      a.m[row] = mx;
      a.l[row] = lsum;
    } else {
      a.pm[(size_t)sp * rows_total + row] = mx;
      a.pl[(size_t)sp * rows_total + row] = lsum;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    float acc = 0.f;
    for (int gi = 0; gi < groups; ++gi) {
      const float* s = scratch + ((size_t)gi * rows_pad + r) * stride;
      acc += s[d] * s[hd];
    }
    const size_t row = out_row(a, b, h, qb, r);
    if (n_sp == 1)
      a.o[row * hd + d] =
          acc / fmaxf(scratch[(size_t)r * stride + hd + 1], 1e-30f);
    else
      a.po[((size_t)sp * rows_total + row) * hd + d] = acc;
  }
}

__device__ inline void write_dead(const Args& a, int b, int h, int qb, int rows) {
  for (int i = threadIdx.x; i < rows * a.hd; i += blockDim.x) {
    const int r = i / a.hd, d = i - r * a.hd;
    const size_t row = out_row(a, b, h, qb, r);
    a.o[row * a.hd + d] = 0.f;
    if (d == 0) {
      a.m[row] = NEG;
      a.l[row] = 0.f;
    }
  }
}

// Common prologue of both paths. Returns false when the block has no work.
struct Span {
  int b, h, qb, sp, n_sp, kl, q0, p0, n_keys, n_stages;
};

// SLICED (a call over a page slice) is a compile-time switch: the kernels
// of unsliced calls carry none of the slice's code.
template <bool SLICED>
__device__ inline bool span_of(const Args& a, int rows, Span& s) {
  s.sp = blockIdx.x;
  s.b = blockIdx.y / a.KV;
  s.h = blockIdx.y - s.b * a.KV;
  s.qb = blockIdx.z;
  const int n_live = live_pages(a, s.b, s.qb);
  // the walk: pages [lo, n_live), from the window's first page
  const int lo = n_live ? first_page(a, s.b, s.qb) : 0;
  const int n_walk = n_live - lo;
  if constexpr (SLICED) {  // the chunks of the walk's runs in the slice
    // runs are at most ceil(n / 2) (an entry outside the slice parts two),
    // so chunks at most that plus n / span_pages: a block past it has no
    // chunk to walk and leaves before the scan
    if (n_live && s.sp >= (n_walk + 1) / 2 + n_walk / a.span_pages)
      return false;
    int n_pg = 0;
    s.n_sp = n_live ? slice_chunks(a, s.b, lo, n_live, s.sp, &s.p0, &n_pg)
                    : 0;
    if (s.n_sp == 0) {  // none of the q block's pages in the slice: rows 0
      if (s.sp == 0) write_dead(a, s.b, s.h, s.qb, rows);
      return false;
    }
    if (s.sp >= s.n_sp) return false;
    s.n_keys = n_pg * a.page;
  } else {
    if (n_live == 0) {  // dead q block: its rows are exactly 0
      if (s.sp == 0) write_dead(a, s.b, s.h, s.qb, rows);
      return false;
    }
    s.n_sp = (n_walk + a.span_pages - 1) / a.span_pages;
    if (s.sp >= s.n_sp) return false;
    s.p0 = lo + s.sp * a.span_pages;
    const int p1 = min(n_live, s.p0 + a.span_pages);
    s.n_keys = (p1 - s.p0) * a.page;
  }
  const int keys = stage_keys(a.hd, a.kind);
  s.n_stages = (s.n_keys + keys - 1) / keys;
  s.kl = a.kv_len[s.b];
  s.q0 = a.q_start[s.b] + s.qb * a.q_blk;
  return true;
}

// ---- launch ----------------------------------------------------------------
template <void (*KERNEL)(Args)>
int launch(dim3 grid, int threads, int smem, const Args& a,
           cudaStream_t stream) {
  // above 48 KB a block's shared memory needs the opt-in, once per kernel
  static int granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t e = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  KERNEL<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The span's table entries into tbl_s: local page ids (a sliced call's
// entries are global ids in its slice).
template <bool SLICED>
__device__ inline void load_span_table(const Args& a, const Span& s,
                                       int* tbl_s) {
  const int n_pg = (s.n_keys + a.page - 1) / a.page;
  for (int i = threadIdx.x; i < n_pg; i += blockDim.x) {
    if constexpr (SLICED)
      tbl_s[i] = a.tbl[(size_t)s.b * a.P + s.p0 + i] - a.slice_first;
    else
      tbl_s[i] = a.tbl[(size_t)s.b * a.P + s.p0 + i];
  }
}

// The chunk path's bf16-mma route (bf16 q over bf16 pages), both slicings:
// paged_attention_chunk_bf16.cu.
int launch_chunk_bf16(dim3 grid, int threads, int smem, const Args& a,
                      cudaStream_t stream);

// The decode path's launchers, one unit per page kind and slicing so that
// they compile in parallel: paged_attention_decode.cu (fp32), _i8.cu,
// _bf16.cu (both routes of bf16 pages), and the _sliced.cu of each.
int launch_decode_f32(dim3 grid, int smem, const Args& a,
                      cudaStream_t stream);
int launch_decode_i8(dim3 grid, int smem, const Args& a, cudaStream_t stream);
int launch_decode_bf16(dim3 grid, int smem, const Args& a,
                       cudaStream_t stream);
int launch_decode_f32_sliced(dim3 grid, int smem, const Args& a,
                             cudaStream_t stream);
int launch_decode_i8_sliced(dim3 grid, int smem, const Args& a,
                            cudaStream_t stream);
int launch_decode_bf16_sliced(dim3 grid, int smem, const Args& a,
                              cudaStream_t stream);

}  // namespace qmc_pa
