"""host_gap_share (%): the device's idle time while the host ran engine
work, over the wall time of the waves the profiler did not cover: every
idle second of ``EngineStats.device_idle_s`` (idle device time charged to
the innermost host span open over it) except those charged to
``step/wait``, where the host waits on the device's readback. None where
the program keeps no device clock."""

WAIT = "step/wait"


def read(r):
    idle = [getattr(s, "device_idle_s", None) for s in r.host_stats]
    if not idle or None in idle or r.host_wall_s <= 0:
        return None
    return 100.0 * sum(v for d in idle for k, v in d.items()
                       if k != WAIT) / r.host_wall_s
