"""``sparse_gram``, one call an exact solve: frozen count (bytes bound
it at 2,048 x 1,048,576) over the profiler's device time."""
from perfbench.counts import sparse_gram
from perfbench.layer_metrics import roofline


def _least(op):
    if op["rank"] is not None:
        return 0.0
    st = op["stats"]
    return sparse_gram.least_seconds(st.nnz, st.pairs, st.m,
                                     st.num_blocks)[0]


def read(td):
    if not any(o["op"] == "solve" and o["rank"] is None for o in td.ops):
        return None
    return roofline(td, "sparse_gram", "solve", _least)
