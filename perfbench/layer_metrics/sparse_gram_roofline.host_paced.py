"""sparse_gram_roofline.solve in the cells whose solves the host paces."""
from perfbench import spec

read = spec.layer_reader("sparse_gram_roofline.solve").read
