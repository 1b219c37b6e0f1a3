// Ragged paged attention, decode path (S = 1), over bf16 pages: the
// instantiations of paged_attention_decode.cuh's kernels for that page kind
// (the shuffle route under an fp32 q, the bf16-mma route under a bf16 q;
// a unit of its own, compiled beside the others). Design note:
// paged_attention.cu.
#include "paged_attention_decode.cuh"

namespace qmc_pa {

int launch_decode_bf16(dim3 grid, int smem, const Args& a, cudaStream_t st) {
  if (a.q_bf16)  // bf16 q over bf16 pages: the bf16-mma route
    return launch_decode_bf16_mma<false>(grid, smem, a, st);
  return launch_decode_kind<KIND_BF16, false>(grid, smem, a, st);
}

}  // namespace qmc_pa
