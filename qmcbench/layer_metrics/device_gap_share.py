"""device_gap_share (%): 1 - the device's busy time over the wall time of
the waves the profiler did not cover. Busy time is the program's own
device clock (``EngineStats.device_busy_s``: the union of its
``device/step`` and ``device/page_ops`` spans, pairs of CUDA events from
each round's upload through its readback copy, and around its page ops),
so no profiler stretches the waves it reads. None where the program keeps
no device clock."""


def read(r):
    busy = [getattr(s, "device_busy_s", None) for s in r.host_stats]
    if not busy or None in busy or r.host_wall_s <= 0:
        return None
    return 100.0 * (1.0 - sum(busy) / r.host_wall_s)
