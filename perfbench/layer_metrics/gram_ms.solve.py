"""Gram, a solve: span ``gram_stack``."""
from perfbench.layer_metrics import per_op_ms


def read(td):
    return per_op_ms(td, ("gram_stack",), "solve")
