"""``sketch_panel``, 1 + power_iters calls a randomized solve (one a
pass): frozen count (bytes bound it) over the profiler's device time."""
from perfbench.counts import sketch_panel
from perfbench.layer_metrics import roofline


def read(td):
    passes = 1 + td.workload["solve"].get("power_iters", 2)

    def least(op):
        if op["rank"] is None:
            return 0.0
        st = op["stats"]
        return passes * sketch_panel.least_seconds(
            st.nnz, st.stored_cols, op["l"], st.m)[0]

    if not any(o["op"] == "solve" and o["rank"] is not None
               for o in td.ops):
        return None
    return roofline(td, "sketch_panel", "solve", least)
