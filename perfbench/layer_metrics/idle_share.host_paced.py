"""idle_share.solve in the cells whose solves the host paces."""
from perfbench import spec

read = spec.layer_reader("idle_share.solve").read
