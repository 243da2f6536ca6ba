"""Top-k serving over a streamed factorization: double-buffered snapshots
(``snapshot``), int8 factors (``kvquant``) and the fused ranker
(``ranker``, the ``topk_score`` kernel underneath).  The front door is
``repro_torch.core.api.serve_init`` / ``serve_topk``.  The LM decode
engine (``engine``: ``generate`` over ``decode_step``) is imported from
its own module."""
from repro_torch.serve.ranker import (  # noqa: F401
    TopKResult, fold_queries, project_rows, score_topk, user_queries,
)
from repro_torch.serve.snapshot import ServingSnapshot, SnapshotBuffer  # noqa: F401

__all__ = ["TopKResult", "fold_queries", "project_rows", "score_topk",
           "user_queries", "ServingSnapshot", "SnapshotBuffer"]
