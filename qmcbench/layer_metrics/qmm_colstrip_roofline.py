"""qmm_colstrip_roofline (%): the column-strip qmm kernel (B3,
``qmm_colstrip_kernel`` and the reduction of its K split,
``qmm_reduce_kernel``): the least time of every call it took in the
traced waves over their device time in the profiler."""

KERNELS = ("qmm_colstrip_kernel", "qmm_reduce_kernel")


def read(r):
    return r.qmm_roofline("colstrip", KERNELS)
