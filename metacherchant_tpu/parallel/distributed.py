"""Multi-host initialization and input sharding.

The reference has NO multi-process path (single JVM, SURVEY §2.3 P5/P6); this
is the new-framework component it implies: jax.distributed process init, a
global 1-D mesh over every chip in the slice, and per-host disjoint input
file sharding so reads stream data-parallel while the k-mer table shards by
hash over all devices (parallel/sharded_count.py).

Collective layout (SURVEY §5.8): key routing and frontier exchange are
all_to_all collectives inside shard_map (NVLink between the cards of one
host); host-level input sharding and final result gathers cross hosts
exactly once.
"""
from __future__ import annotations

import os

import jax
import numpy as np


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """jax.distributed.initialize with env fallbacks (no-op single-process)."""
    coordinator = coordinator or os.environ.get("MC_COORDINATOR")
    if coordinator is None:
        return  # single-host
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes or int(os.environ.get("MC_NUM_PROCESSES", "1")),
        process_id=process_id if process_id is not None
        else int(os.environ.get("MC_PROCESS_ID", "0")))


def shard_files_for_host(files: list[str]) -> list[str]:
    """Disjoint per-host file assignment (round-robin by process index).

    Every k-mer is still counted exactly once globally because each host
    inserts only its own files' keys and the table merge is a commutative sum
    (the reference's dispatcher hands disjoint read ranges to threads,
    src/io/ReadsDispatcher.java:34-53 -- same invariant, scaled to hosts)."""
    pid = jax.process_index()
    n = jax.process_count()
    return [f for i, f in enumerate(files) if i % n == pid]


def global_mesh(axis: str = "d"):
    from .sharded_count import make_mesh
    return make_mesh(jax.devices(), axis)
