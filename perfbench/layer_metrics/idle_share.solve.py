"""Device: percent of the traced window with nothing running on the
card (torch.profiler)."""
from perfbench.layer_metrics import idle_share


def read(td):
    return idle_share(td)
