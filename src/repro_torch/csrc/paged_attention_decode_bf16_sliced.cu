// Ragged paged attention, decode path (S = 1), over bf16 pages of a page
// slice (a data rank's, on a mesh): the instantiations of
// paged_attention_decode.cuh's kernel for that page kind and slicing, in
// a unit of their own so that they compile in parallel with the others.
// Design note: paged_attention.cu.
#include "paged_attention_decode.cuh"

namespace qmc_pa {

int launch_decode_bf16_sliced(dim3 grid, int smem, const Args& a,
                              cudaStream_t st) {
  return launch_decode_kind<KIND_BF16, true>(grid, smem, a, st);
}

}  // namespace qmc_pa
