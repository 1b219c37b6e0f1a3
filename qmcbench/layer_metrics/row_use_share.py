"""row_use_share (%): the live rows of the step (``EngineStats.
step_live_rows``: chunk tokens, one a decode lane, verify drafts) over the
rows it computed (``step_rows``: ``[slots, C]`` a round, ``[1, C]`` on the
solo lane), over the waves the profiler did not cover. Read from waves
run on the card alone (those that carry the program's device clock,
``device_busy_s``), as the device's metrics are; None elsewhere, and where
the program does not count the rows."""


def read(r):
    if not r.host_stats or any(getattr(s, "device_busy_s", None) is None
                               for s in r.host_stats):
        return None
    rows = sum(s.step_rows for s in r.host_stats)
    if not rows:
        return None
    return 100.0 * sum(s.step_live_rows for s in r.host_stats) / rows
