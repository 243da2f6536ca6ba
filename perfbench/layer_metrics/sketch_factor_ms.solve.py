"""Gram and sketch, a solve: the randomized solve's work outside the
passes that ``sketch_ms`` times: spans ``sketch_index`` (the row and
repair indexes sorted once a solve), ``sketch_gram``, ``truncate_sketch``
and ``right_vectors``."""
from perfbench.layer_metrics import per_op_ms


def read(td):
    return per_op_ms(td, ("sketch_index", "sketch_gram", "truncate_sketch",
                          "right_vectors"), "solve")
