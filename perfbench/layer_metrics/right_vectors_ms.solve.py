"""Right vectors, a solve: span ``right_vectors_stack`` (V = A^T U / S,
block by block)."""
from perfbench.layer_metrics import per_op_ms


def read(td):
    return per_op_ms(td, ("right_vectors_stack",), "solve")
