"""Ranky core: distributed SVD on large sparse matrices (the paper's
contribution), in PyTorch.

Public surface (``__all__``):

* ``api``: the one front door: ``api.svd(a, SolveConfig(...)) ->
  SVDResult`` with an explainable plan (``api.plan``) and diagnostics;
  streaming (``svd_init`` / ``plan_update`` / ``svd_update`` /
  ``svd_stream``) and serving
  (``api.serve_init`` / ``api.serve_topk``).  The streaming names,
  ``SolveConfig`` / ``SVDResult`` / ``Plan`` / ``ASpec`` / ``plan`` are
  re-exported here for convenience, as in the reference.
* ``ranky_svd``: the legacy entry point, a thin shim over the same engine.
* ``sparse`` / ``randomized`` / ``planner`` / ``convert``: submodules.
* ``stages``: opt-in wall times of a solve's stages (port only, until the
  observability package is ported).
* ``svd``: NOTE: this name is the *local SVD primitives submodule*
  (``repro_torch.core.svd``), as in the reference; the unified solver
  function lives at ``repro_torch.core.api.svd``.
* The Ranky checker primitives (``lonely_rows``, ``repair_block``, ...).
"""
from repro_torch.core.ranky import (  # noqa: F401
    DEFAULT_SEED,
    METHODS,
    RepairDraws,
    lonely_rows,
    random_checker,
    neighbor_checker,
    neighbor_random_checker,
    repair_block,
    repair_block_sparse,
    ranky_svd,
    row_adjacency,
    row_adjacency_sparse,
    sparse_lonely_rows,
    split_and_repair,
)
from repro_torch.core import (  # noqa: F401
    convert, planner, randomized, sparse, stages, svd)
from repro_torch.core import api  # noqa: F401  (imports ranky/planner; keep last)
from repro_torch.core.api import (  # noqa: F401
    SolveConfig,
    SVDResult,
    Diagnostics,
    plan,
    plan_update,
    svd_init,
    svd_stream,
    svd_update,
)
from repro_torch.core.planner import ASpec, Plan, PlanError  # noqa: F401

__all__ = [
    # the unified front door
    "api", "SolveConfig", "SVDResult", "Diagnostics", "plan",
    "ASpec", "Plan", "PlanError", "planner", "DEFAULT_SEED",
    # the streaming front door (repro_torch.stream underneath)
    "svd_init", "svd_update", "svd_stream", "plan_update",
    # legacy entry point (deprecation shim over the same engine)
    "ranky_svd",
    # submodules
    "sparse", "randomized", "svd", "convert", "stages",
    # checker primitives and their random inputs
    "METHODS", "RepairDraws", "lonely_rows", "random_checker",
    "neighbor_checker", "neighbor_random_checker", "repair_block",
    "repair_block_sparse", "row_adjacency", "row_adjacency_sparse",
    "sparse_lonely_rows", "split_and_repair",
]
