"""syncs.solve in the cells whose solves the host paces."""
from perfbench import spec

read = spec.layer_reader("syncs.solve").read
