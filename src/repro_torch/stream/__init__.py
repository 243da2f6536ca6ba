"""Streaming SVD: the incremental merge-and-truncate subsystem.

Turns the one-shot solver into a long-lived service: a
:class:`~repro_torch.stream.state.StreamingSVDState` plus an
:func:`~repro_torch.stream.ingest.ingest` engine that folds batches of
new rows (dense, COO or BlockEll deltas) into the truncated factorization
via Ranky-repaired, sparse-native batch factorization and a panel merge.
The public front door lives at ``repro_torch.core.api.svd_init`` /
``svd_update`` / ``svd_stream``; :mod:`repro_torch.stream.window` folds
same-bucket batches in windows with the state on the device (rule R6).
The sharded engine is not ported yet.
"""
from repro_torch.stream.decay import decay_from_timestamps  # noqa: F401
from repro_torch.stream.ingest import (  # noqa: F401
    IngestInfo,
    ingest,
    ingest_shard_map,
    install_fault_seam,
)
from repro_torch.stream.window import (  # noqa: F401
    adaptive_oversample,
    bucket_signature,
    build_window,
    ingest_window,
)
from repro_torch.stream.state import (  # noqa: F401
    StreamingSVDState,
    as_delta,
    delta_shape,
    init_state,
)

__all__ = [
    "StreamingSVDState", "init_state", "ingest", "ingest_shard_map",
    "ingest_window", "bucket_signature", "build_window",
    "adaptive_oversample",
    "install_fault_seam", "IngestInfo", "as_delta", "delta_shape",
    "decay_from_timestamps",
]
