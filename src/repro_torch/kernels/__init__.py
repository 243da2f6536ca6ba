"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, plus the ``nvcc`` + ``ctypes`` build (``build.py``)."""

KERNELS = ("sparse_gram", "blockgram", "sketch_panel", "topk_score",
           "flash_attention", "ssd_scan")


def launch_counts() -> dict:
    """{kernel: launches so far in this process}: each wrapper adds one
    where it launches its kernel on the card (a CPU tensor takes the plain
    version and counts nothing)."""
    import importlib
    return {name: importlib.import_module(f"repro_torch.kernels.{name}")
            .launches for name in KERNELS}
