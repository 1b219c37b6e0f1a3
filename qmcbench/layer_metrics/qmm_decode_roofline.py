"""qmm_decode_roofline (%): the decode-width qmm kernel (B2,
``qmm_decode_kernel``): the least time of every call it took in the
traced waves (``work.qmm_call`` at the rows the plan pads to) over its
device time in the profiler."""
KERNELS = ("qmm_decode_kernel",)


def read(r):
    return r.qmm_roofline("decode", KERNELS)
