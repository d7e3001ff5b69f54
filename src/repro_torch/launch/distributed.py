"""Multi-process launch: one ``torch.distributed`` rank a card.

Port of ``repro/launch/distributed.py``.  One call per process, before any
tensor is made:

    from repro_torch.launch import distributed, mesh
    distributed.initialize("10.0.0.1:29500", num_processes=4,
                           process_id=rank)
    node_mesh = mesh.make_node_mesh(4)

``coordinator`` is ``host:port`` of process 0 (a TCP store) or any
``torch.distributed`` init URL (``tcp://host:port``, ``file:///path``).
The backend is NCCL on a machine with CUDA and gloo on the CPU; asking for
NCCL without a card raises: there is no quiet switch between them.  Under
NCCL every rank takes ``cuda:<local rank>`` and no two ranks may share a
card: the ranks check that through the store before NCCL is set up (NCCL
itself fails later, and cryptically, on a duplicate device).
"""
from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

__all__ = ["initialize", "shutdown"]


def _init_url(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def _duplicates(entries: list) -> list:
    """Ranks whose ``host/device`` entry an earlier rank already has."""
    seen, dup = {}, []
    for rank, e in enumerate(entries):
        if e in seen:
            dup.append((seen[e], rank, e))
        else:
            seen[e] = rank
    return dup


def _one_rank_per_card(store, rank: int, world: int, local_rank: int):
    """Every rank publishes ``<host>/cuda:<local rank>`` and reads all of
    them; a card taken twice raises before NCCL is set up."""
    store = dist.PrefixStore("repro_torch/cards", store)
    store.set(str(rank), f"{socket.gethostname()}/cuda:{local_rank}")
    entries = [store.get(str(r)).decode() for r in range(world)]
    dup = _duplicates(entries)
    if dup:
        a, b, e = dup[0]
        raise ValueError(
            f"ranks {a} and {b} both run on {e}: NCCL needs one rank per "
            "card; start at most torch.cuda.device_count() ranks a host "
            "and give each its own local rank")


def initialize(coordinator: str, num_processes: int, process_id: int, *,
               backend: str | None = None,
               timeout_s: float = 300.0) -> torch.device:
    """Join this process to a ``num_processes``-rank group as rank
    ``process_id``; returns the rank's device.  ``backend`` defaults to
    ``'nccl'`` where CUDA is available, else ``'gloo'``.  Under NCCL the
    device is ``cuda:<local rank>`` (``$LOCAL_RANK``, else
    ``process_id``); a local rank without a card of its own raises
    ``ValueError``.  ``timeout_s`` bounds the rendezvous and every
    collective.  Pair with :func:`shutdown`."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    timeout = datetime.timedelta(seconds=timeout_s)
    device = torch.device("cpu")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend='nccl' needs a CUDA device and there is none; run "
                "on the CPU with backend='gloo'")
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        cards = torch.cuda.device_count()
        if local_rank >= cards:
            raise ValueError(
                f"rank {process_id} would take cuda:{local_rank}, but this "
                f"host has {cards} card(s): NCCL needs one rank per card; "
                f"start at most {cards} ranks a host")
        device = torch.device("cuda", local_rank)
    store, rank, world = next(dist.rendezvous(
        _init_url(coordinator), rank=process_id, world_size=num_processes,
        timeout=timeout))
    if backend == "nccl":
        _one_rank_per_card(store, rank, world, local_rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    return device


def shutdown() -> None:
    """Leave the process group (a no-op if none is set up)."""
    if dist.is_initialized():
        dist.destroy_process_group()
