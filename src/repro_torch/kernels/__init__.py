"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, plus the ``nvcc`` + ``ctypes`` build (``build.py``)."""
