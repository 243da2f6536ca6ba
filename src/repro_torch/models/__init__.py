"""Model definitions of the port: layers, attention, SSM, the forward
passes of the served LM families (hybrid, ssm, dense, vlm), the parameter
schema and the converter from the reference's parameters."""
