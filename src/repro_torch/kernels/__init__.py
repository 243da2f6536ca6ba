"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, plus the ``nvcc`` + ``ctypes`` build (``build.py``)."""

KERNELS = ("sparse_gram", "blockgram", "sketch_panel", "topk_score",
           "flash_attention", "ssd_scan", "right_vectors")

# Cost counters open in this process (``launch/hlocost.Counter``), which
# the counting mesh's collectives charge too (``hlocost.record_collective``).
# A wrapper called on the ``meta`` device executes nothing: it returns empty
# outputs of its kernel's shapes and charges each open counter once with
# the kernel's closed form (its ``work``), since the card runs one kernel
# there, not the plain version's ops.
meta_counters: list = []


def charge_meta(name: str, nbytes: float, flops: float) -> None:
    for counter in meta_counters:
        counter.charge_kernel(name, nbytes, flops)


def launch_counts() -> dict:
    """{kernel: launches so far in this process}: each wrapper adds one
    where it launches its kernel on the card (a CPU tensor takes the plain
    version and counts nothing)."""
    import importlib
    return {name: importlib.import_module(f"repro_torch.kernels.{name}")
            .launches for name in KERNELS}
