"""Front door, a solve: each ``svd.call`` span (the root of one
``api.svd`` call) less its children ``describe_and_plan``,
``as_block_input`` and ``svd.solve``: the call clock's two syncs, the
truncation and trim of the factors, and ``diagnostics``."""
CALL = "svd.call"
TIMED_CHILDREN = ("describe_and_plan", "as_block_input", "svd.solve")


def read(td):
    n = td.count("solve")
    calls = {ev.span_id: ev.dur_us for ev in td.spans if ev.name == CALL}
    if n == 0 or not calls:
        return None
    children = sum(ev.dur_us for ev in td.spans
                   if ev.name in TIMED_CHILDREN and ev.parent in calls)
    return (sum(calls.values()) - children) * 1e-3 / n
