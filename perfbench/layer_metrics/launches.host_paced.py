"""launches.solve in the cells whose solves the host paces."""
from perfbench import spec

read = spec.layer_reader("launches.solve").read
