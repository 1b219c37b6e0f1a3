// 3-bit bitstream decode (the ReRAM read path) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/unpack3b.py
// unpack3b_pallas (body _unpack3b_kernel): a little-endian 3-bit code
// stream (uint8 bytes, as core/packing.py pack_codes writes it) becomes
// int32 codes minus the bias 4, 8 codes per 3 bytes.
//
// What bounds it on an H100: bytes. It reads 3n/8 bytes and writes 4n,
// with no arithmetic to speak of, so the only aim is full-rate stores.
// The TPU kernel expands 3-byte groups into a whole VMEM code tile; here
// every thread owns 4 codes (12 bits, one 16-byte int4 store), so a
// warp's store instruction writes 512 contiguous bytes and no store is
// partial. Quad q's bits start at bit 12q: byte 3q/2, shifted by 4 when
// q is odd, so two byte loads (cached: neighbouring quads share a byte)
// give all of them. Each thread decodes QUADS_PER_THREAD quads one block
// width apart, which keeps its loads in flight together while every
// store instruction stays contiguous across the warp. Any n > 0 is taken:
// when n % 4 != 0 the last quad is partial, stores its 1-3 codes one by
// one, and its second byte may lie past the stream's ceil(3n/8) bytes,
// so that load is guarded (a whole quad's second byte never does).
// Indices are 64-bit (a full-width lm_head inlier stream is 143,864,832
// codes, a 575 MB output).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int QUADS_PER_THREAD = 4;

__global__ void __launch_bounds__(THREADS)
unpack3b_kernel(const uint8_t* __restrict__ packed, int4* __restrict__ out,
                long long n, long long n_bytes) {
  const long long n_quads = (n + 3) / 4;
  const long long base =
      (long long)blockIdx.x * (THREADS * QUADS_PER_THREAD) + threadIdx.x;
  uint32_t bits[QUADS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < QUADS_PER_THREAD; ++i) {
    const long long q = base + (long long)i * THREADS;
    bits[i] = 0;
    if (q < n_quads) {
      const long long byte = (q * 3) >> 1;
      const uint32_t hi =
          byte + 1 < n_bytes ? (uint32_t)__ldg(packed + byte + 1) : 0u;
      const uint32_t w = (uint32_t)__ldg(packed + byte) | (hi << 8);
      bits[i] = w >> ((q & 1) * 4);
    }
  }
#pragma unroll
  for (int i = 0; i < QUADS_PER_THREAD; ++i) {
    const long long q = base + (long long)i * THREADS;
    const uint32_t w = bits[i];
    if (4 * q + 4 <= n) {
      out[q] = make_int4((int)(w & 7u) - 4, (int)((w >> 3) & 7u) - 4,
                         (int)((w >> 6) & 7u) - 4, (int)((w >> 9) & 7u) - 4);
    } else if (q < n_quads) {
      int* tail = reinterpret_cast<int*>(out) + 4 * q;
      for (int j = 0; j < (int)(n - 4 * q); ++j)
        tail[j] = (int)((w >> (3 * j)) & 7u) - 4;
    }
  }
}

}  // namespace

extern "C" {

// packed: ceil(3n/8) bytes; out: n int32, 16-byte aligned; n > 0.
// Returns cudaGetLastError().
int qmc_unpack3b(const void* packed, void* out, long long n, void* stream) {
  const long long n_quads = (n + 3) / 4;
  const long long per_block = (long long)THREADS * QUADS_PER_THREAD;
  const long long blocks = (n_quads + per_block - 1) / per_block;
  unpack3b_kernel<<<(unsigned)blocks, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<int4*>(out), n,
      (3 * n + 7) / 8);
  return (int)cudaGetLastError();
}

}  // extern "C"
