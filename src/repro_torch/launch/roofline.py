"""Roofline terms of a dry-run cell on an H100 model.

The counterpart of ``repro.launch.roofline``.  Three terms per (arch x
shape x mesh), in seconds:

  compute    = flops a rank / PEAK_FLOPS
  memory     = bytes a rank / HBM_BW
  collective = collective bytes a rank / LINK_BW

The counts are one rank's (``launch/hlocost.py``: a rank's step run on
``meta`` under the cost counter), so "per chip" is one card, as the
reference's per-device SPMD program is one chip.

Hardware model: one NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core
GPU datasheet: 989e12 dense bf16 tensor-core FLOP/s (1,979 with
sparsity, not used) and 3.35e12 B/s of HBM3, the figures ``PERF.md`` §6
and ``chip_smoke.py`` use for their bounds.  The link: the production mesh
(``launch/mesh.py``) is 256 cards, 32 hosts of 8 (DGX H100 / HGX H100
nodes), so its 16-wide ``model`` axis spans two hosts and each collective
over it crosses the inter-node fabric: one ConnectX-7 400 Gb/s NDR
InfiniBand port a GPU in NVIDIA's DGX H100 system specification, 50e9
B/s each way (NVLink 4 within a host is 450e9 B/s each way, 900e9 both,
not the bottleneck of a ring that crosses hosts).  One peak for every
dtype, as the reference keeps one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores, per card
HBM_BW = 3.35e12           # bytes/s per card
LINK_BW = 50e9             # bytes/s per card, 400 Gb/s NDR InfiniBand


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float          # analytic 6ND (train) / 2ND (inference)
    collective_detail: Optional[Dict[str, int]] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        """model_flops / the counted global FLOPs: how much of the counted
        compute is useful (catches remat recompute, padding, replicated
        work)."""
        total = self.hlo_flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of peak useful FLOPs: the ideal step time
        is bounded below by max(terms); useful work is model_flops."""
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        if t_bound <= 0:
            return 0.0
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / t_bound

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops_global": self.hlo_flops_per_chip * self.chips,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collective_detail": self.collective_detail,
        }


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step: 6*N_active*tokens for training,
    2*N_active*tokens for inference forward (decode: tokens = batch)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def build(arch: str, shape, mesh_name: str, chips: int, cost, cfg
          ) -> Roofline:
    """Roofline terms from a rank's :class:`hlocost.Cost`; the collective
    detail keeps the bytes and counts by kind and the LM kernels' calls."""
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops_per_chip=cost.flops,
        hlo_bytes_per_chip=cost.bytes,
        collective_bytes_per_chip=cost.collective_bytes,
        model_flops=model_flops(cfg, shape),
        collective_detail={
            "bytes": {k: v for k, v in cost.collective.items() if v},
            "counts": {k: v for k, v in cost.collective_count.items() if v},
            "kernel_calls": dict(cost.kernel_calls),
        },
    )
