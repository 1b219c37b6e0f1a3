// Ragged paged attention, decode path (S = 1), over int8 pages: the
// instantiations of paged_attention_decode.cuh's kernel for that page kind
// (a unit of its own, compiled beside the others). Design note:
// paged_attention.cu.
#include "paged_attention_decode.cuh"

namespace qmc_pa {

int launch_decode_i8(dim3 grid, int smem, const Args& a, cudaStream_t st) {
  return launch_decode_kind<KIND_I8, false>(grid, smem, a, st);
}

}  // namespace qmc_pa
