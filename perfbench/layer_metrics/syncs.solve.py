"""Device: host syncs a solve.  The host's runtime calls that wait for
the card (``cudaDeviceSynchronize``, ``cudaStreamSynchronize``,
``cudaEventSynchronize``) inside the profiler ranges of the program's
``svd.call`` spans, over those calls (``launches.solve``'s count)."""
from perfbench import spec

SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
         "cudaEventSynchronize")


def read(td):
    return spec.layer_reader("launches.solve").per_call(td, SYNCS)
