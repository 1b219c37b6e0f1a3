"""mfu (%): the whole step's share of the chip's peak. Each round's least
time (``work.step_need`` of its live lanes: every weight once at its
format's bits, the products of the live tokens, the head only for
emitted tokens, attention over the needed pages, SSM state) summed over
the waves the profiler did not cover, over those waves' wall time (the
profiler's kernel records stretch the waves it covers)."""
from qmcbench import work


def read(r):
    if not r.host_rounds or r.host_wall_s <= 0:
        return None
    least = sum(work.least_s(*work.step_need(
        r.model, r.quant, r.projs, rd.lanes, rd.emitting, r.page))
        for rd in r.host_rounds)
    return 100.0 * least / r.host_wall_s
