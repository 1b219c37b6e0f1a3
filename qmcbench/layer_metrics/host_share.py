"""host_share (%): the engine's host phases (admission, grants, input
prep and page ops, emission: ``EngineStats.host_seconds()``) over the
wall time of the waves the profiler did not cover. In the pipelined loop
host phases may overlap device work, so this is the host's load, not
time the device waited."""


def read(r):
    if r.host_wall_s <= 0:
        return None
    return 100.0 * sum(s.host_seconds() for s in r.host_stats) \
        / r.host_wall_s
