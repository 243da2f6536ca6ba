"""Sketch, a solve: spans ``sketch``, ``pullback`` and ``qr``."""
from perfbench.layer_metrics import per_op_ms


def read(td):
    return per_op_ms(td, ("sketch", "pullback", "qr"), "solve")
