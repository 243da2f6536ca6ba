"""Kernels: launches a solve.  The host's runtime calls that launch work
on the card (names starting ``cudaLaunch`` or ``cuLaunch``) inside the
profiler ranges of the program's ``svd.call`` spans, over those calls."""
import bisect

CALL = "svd.call"
LAUNCH = ("cudaLaunch", "cuLaunch")


def per_call(td, names):
    """Host runtime calls whose name starts with one of ``names`` inside
    the window's ``svd.call`` ranges, over those ranges.  None where the
    trace holds no such range, or no runtime launch at all (the CPU traces
    none): a count is never 0 for want of a trace."""
    lo, hi = td.window_ns
    calls = sorted((iv.start_ns, iv.end_ns) for iv in td.host
                   if iv.name == CALL and lo <= iv.start_ns
                   and iv.end_ns <= hi)
    if not calls or not any(iv.name.startswith(LAUNCH) for iv in td.host):
        return None
    starts = [a for a, _ in calls]
    n = 0
    for iv in td.host:
        if iv.name.startswith(names):
            i = bisect.bisect_right(starts, iv.start_ns) - 1
            if i >= 0 and iv.end_ns <= calls[i][1]:
                n += 1
    return n / len(calls)


def read(td):
    return per_call(td, LAUNCH)
