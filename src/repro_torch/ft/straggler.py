"""Straggler detection & mitigation.

At thousand-node scale the slowest host sets the step time (synchronous
SPMD).  This module tracks per-host step-time EWMAs, flags persistent
outliers, and drives the mitigation policy:

  * ``flag``     — log & export the host list (ops integration)
  * ``evict``    — treat the host as failed: trigger an elastic re-mesh
                   (ft/elastic.py) without it at the next checkpoint
                   boundary

Timing source: on a real deployment every host reports its local step
wall-time through the metrics all-gather that the train loop already
does.  ``observe`` consumes raw per-host times; ``observe_window`` is
the ``repro_torch.obs``-fed adapter the streaming supervisor uses: one
chunk's duration fanned out by per-slot skew factors, scaled up by the
plan-vs-measured drift gauge when a window blew its planned working set
(a slot that is slow *and* over-plan is slow for a reason the EWMA
should weigh).  The arithmetic is the reference's, number for number."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class StragglerConfig:
    alpha: float = 0.1           # EWMA coefficient
    threshold: float = 1.5       # flag if ewma > threshold * median
    patience: int = 10           # consecutive flagged steps before evict
    policy: str = "flag"         # "flag" | "evict"


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig, num_hosts: int):
        self.cfg = cfg
        self.num_hosts = num_hosts
        self.ewma: List[Optional[float]] = [None] * num_hosts
        self.flag_streak = [0] * num_hosts

    def observe(self, step_times: Dict[int, float]) -> Dict[str, list]:
        """Feed one step's per-host wall times.  Returns the current
        flagged / evict-recommended host lists."""
        for h, t in step_times.items():
            if not 0 <= h < self.num_hosts:
                raise ValueError(
                    f"host id {h} outside [0, {self.num_hosts})")
            prev = self.ewma[h]
            self.ewma[h] = t if prev is None else \
                (1 - self.cfg.alpha) * prev + self.cfg.alpha * t
        known = sorted(e for e in self.ewma if e is not None)
        if not known:
            return {"flagged": [], "evict": []}
        mid = len(known) // 2
        # true median: with an even host count the upper-middle value
        # would let one slow host of two drag the threshold up past
        # itself and never get flagged
        median = known[mid] if len(known) % 2 else \
            0.5 * (known[mid - 1] + known[mid])
        flagged = []
        for h, e in enumerate(self.ewma):
            if e is not None and e > self.cfg.threshold * median:
                self.flag_streak[h] += 1
                flagged.append(h)
            else:
                self.flag_streak[h] = 0
        evict = [h for h in flagged
                 if self.flag_streak[h] >= self.cfg.patience
                 and self.cfg.policy == "evict"]
        return {"flagged": flagged, "evict": evict}

    def observe_window(self, span_dur_s: float,
                       skew_factors: Sequence[float], *,
                       drift: Optional[float] = None) -> Dict[str, list]:
        """The ``repro_torch.obs``-fed feed: one window's duration
        (seconds), fanned to per-slot times by measured (or injected)
        per-slot skew factors, scaled by the worst plan-vs-measured drift
        ratio when > 1.  On a multi-host deployment the factors come from
        each host's own span ring; on a local mesh (one card's clock for
        every slot) they come from the fault injector's delay seam.
        Returns :meth:`observe`'s verdict."""
        if len(skew_factors) != self.num_hosts:
            raise ValueError(
                f"observe_window got {len(skew_factors)} skew factors "
                f"for {self.num_hosts} hosts")
        scale = max(1.0, drift) if drift is not None else 1.0
        return self.observe(
            {h: span_dur_s * f * scale
             for h, f in enumerate(skew_factors)})
