"""Model definitions of the port: layers, attention, SSM, the hybrid
family's forward passes, the parameter schema and the converter from the
reference's parameters."""
