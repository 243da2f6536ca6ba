"""The plain references, one module per traffic kind, in float64 with
NumPy-free PyTorch; they import nothing of the program (``repro_torch``)
and nothing of JAX or of the JAX package."""
