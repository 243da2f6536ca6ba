"""front_door_ms.solve in the cells whose solves the host paces."""
from perfbench import spec

read = spec.layer_reader("front_door_ms.solve").read
