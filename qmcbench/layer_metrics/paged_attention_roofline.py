"""paged_attention_roofline (%): the ragged paged-attention kernel (B1:
its chunk and decode routes and the merge of its split spans): the least
time of every call in the traced waves (``work.attention_call`` of each
layer over the round's live lanes, pages from the window's floor) over
their device time in the profiler."""
from qmcbench import work

KERNELS = ("attn_chunk", "attn_decode", "attn_merge")


def read(r):
    if not r.rounds or r.device is None:
        return None
    device = r.kernel_seconds(KERNELS)
    if device <= 0:
        return None
    least = 0.0
    for rd in r.rounds:
        for window, layers in work.attention_windows(r.model).items():
            least += layers * work.least_s(*work.attention_call(
                rd.lanes, r.model, window, r.page))
    return 100.0 * least / device
