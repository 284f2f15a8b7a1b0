"""Multi-host initialization.

The reference has no distributed support (SURVEY.md §2.9); this framework
scales the same single-program code across hosts: `jax.distributed` wires
the processes over the host network, the global mesh spans all devices, and per-host data
loading feeds the local shard of the batch (host h loads rows
[h*B/H, (h+1)*B/H) and `jax.make_array_from_process_local_data` assembles
the global sharded batch).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> int:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID).  Returns the
    process id.  No-op for single-process runs."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return 0
    num_processes = num_processes or int(os.environ["NUM_PROCESSES"])
    process_id = process_id if process_id is not None \
        else int(os.environ["PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return process_id


def global_batch_from_local(batch: Dict[str, np.ndarray], mesh: Mesh,
                            axis: str = "data"):
    """Assemble a globally-sharded batch from this host's local rows."""
    sharding = NamedSharding(mesh, P(axis))
    out = {}
    for k, v in batch.items():
        out[k] = jax.make_array_from_process_local_data(sharding, v)
    return out


def local_rows(n_global: int) -> slice:
    """The row range this host should load."""
    h = jax.process_index()
    H = jax.process_count()
    per = n_global // H
    return slice(h * per, (h + 1) * per)
