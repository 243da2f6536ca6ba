"""Repair, a solve: span ``split_and_repair``."""
from perfbench.layer_metrics import per_op_ms


def read(td):
    return per_op_ms(td, ("split_and_repair",), "solve")
