"""Merge, a solve: spans ``merge_grams_eigh`` and ``eigh_to_svd``."""
from perfbench.layer_metrics import per_op_ms


def read(td):
    return per_op_ms(td, ("merge_grams_eigh", "eigh_to_svd"), "solve")
