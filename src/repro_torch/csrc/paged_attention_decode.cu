// Ragged paged attention, decode path (S = 1), over fp32 pages: the
// instantiations of paged_attention_decode.cuh's kernel for that page kind
// (int8 pages: paged_attention_decode_i8.cu; bf16: _bf16.cu). Design
// note: paged_attention.cu.
#include "paged_attention_decode.cuh"

namespace qmc_pa {

int launch_decode_f32(dim3 grid, int smem, const Args& a, cudaStream_t st) {
  return launch_decode_kind<KIND_F32, false>(grid, smem, a, st);
}

}  // namespace qmc_pa
