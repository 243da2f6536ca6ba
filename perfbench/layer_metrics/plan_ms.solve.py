"""Front door and planner, a solve: spans ``describe_and_plan`` and
``as_block_input``."""
from perfbench.layer_metrics import per_op_ms


def read(td):
    return per_op_ms(td, ("describe_and_plan", "as_block_input"), "solve")
