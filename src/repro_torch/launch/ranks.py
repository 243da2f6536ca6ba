"""Ranks and the LM's mesh for both launchers (``launch/serve.py``,
``launch/train.py``): one process a mesh slot, started the same way on
every host with ``--coordinator host:port --num-hosts N --host-id i``
(the process group's ``tcp://`` rendezvous, world size and rank) and
``--ranks-per-host R`` (default: all N on one host).  Rank i runs on host
i // R as its local rank i % R.  NCCL where every rank of a host has a card
of its own; gloo where ranks share a card or run on the CPU.
"""
from __future__ import annotations

import argparse
import datetime
from typing import Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import collectives
from repro_torch.ft.elastic import build_mesh, plan_mesh


def add_rank_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous")
    ap.add_argument("--num-hosts", type=int, default=1,
                    help="ranks in all (one process a mesh slot)")
    ap.add_argument("--host-id", type=int, default=None,
                    help="this process's rank")
    ap.add_argument("--ranks-per-host", type=int, default=None,
                    help="ranks on each host (default: --num-hosts)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")


def rank_layout(host_id: int, ranks_per_host: int, cards: int
                ) -> Tuple[str, Optional[int]]:
    """(backend, card index) of rank ``host_id`` when ``ranks_per_host``
    ranks run on each host of ``cards`` cards: NCCL and the local rank's
    own card when every rank of a host has one, else gloo (ranks sharing
    cards round robin; no card: None).  Every rank reckons the same
    backend from the same layout."""
    local = host_id % ranks_per_host
    if cards == 0:
        return "gloo", None
    if ranks_per_host <= cards:
        return "nccl", local
    return "gloo", local % cards


def start_ranks(coordinator, num_hosts: int, host_id, device,
                ranks_per_host: Optional[int] = None):
    """Join the process group of ``num_hosts`` ranks at ``coordinator``
    (host:port) as rank ``host_id``; returns this rank's device (its card
    by :func:`rank_layout`, unless ``device`` names one) and the pool: a
    ``ProcessGroupMesh`` of one slot a rank, or without a coordinator a
    ``LocalMesh`` of one slot."""
    if not coordinator:
        if num_hosts > 1:
            raise ValueError("--num-hosts > 1 needs --coordinator host:port")
        dev = resolve_device(device)
        return dev, collectives.LocalMesh(1, dev)
    if host_id is None or not 0 <= host_id < num_hosts:
        raise ValueError(f"--host-id must be in [0, {num_hosts}); got "
                         f"{host_id}")
    per_host = num_hosts if ranks_per_host is None else ranks_per_host
    if per_host < 1 or num_hosts % per_host:
        raise ValueError(f"--ranks-per-host {per_host} does not divide "
                         f"--num-hosts {num_hosts}")
    if device is None:
        resolve_device(None)            # raises without a GPU
    dev = resolve_device(device)
    backend, card = rank_layout(
        host_id, per_host,
        torch.cuda.device_count() if dev.type == "cuda" else 0)
    if device is None:
        dev = torch.device("cuda", card)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_hosts,
        rank=host_id, timeout=datetime.timedelta(seconds=300))
    return dev, collectives.ProcessGroupMesh({"blocks": num_hosts},
                                             device=dev)


def model_mesh(pool, model_parallel: int, log=print):
    """The LM's mesh over ``pool``: ``plan_mesh`` then ``build_mesh``
    (None on a rank the plan leaves idle).  The plan is logged where the
    reference logs it: on more than one slot or ``model_parallel`` > 1."""
    plan = plan_mesh(pool.size, model_parallel=model_parallel)
    if pool.size > 1 or model_parallel > 1:
        log(f"mesh: {plan.shape} {plan.axis_names} "
            f"({plan.dropped_devices} devices idle)")
    return build_mesh(plan, pool)


def stop_ranks(coordinator) -> None:
    if coordinator:
        torch.distributed.destroy_process_group()
