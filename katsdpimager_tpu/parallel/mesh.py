"""Device mesh construction for the imaging workload.

Axes, which follow the algorithm (the cards of a host are joined all to
all, so no placement is preferred):

- ``chan``: frequency channels — the primary data-parallel axis (zero
  steady-state communication);
- ``vis``: visibility buckets within a channel — reduction-heavy (psum of
  grids over the cards that share a channel).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

logger = logging.getLogger(__name__)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Initialise multi-host JAX (call before any device use).

    Pass the coordinator address (``host:port``), the process count and
    this process's id; without them ``jax.distributed.initialize()`` needs
    a cluster environment to discover.  After this, :func:`make_mesh` sees
    the global device set; the ``chan`` axis may span hosts (it carries no
    steady-state communication) while the ``vis`` axis should stay within
    a host.
    """
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
    logger.info("distributed: process %d/%d, %d global devices",
                jax.process_index(), jax.process_count(),
                jax.device_count())


def make_mesh(devices: Optional[Sequence] = None, vis_shards: int = 1) -> Mesh:
    """Build a ("chan", "vis") mesh over the given (or all) devices.

    ``vis_shards`` devices cooperate on each channel; the rest of the
    devices spread over channels.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % vis_shards != 0:
        raise ValueError(f"{n} devices not divisible by vis_shards={vis_shards}")
    arr = np.asarray(devices).reshape(n // vis_shards, vis_shards)
    return Mesh(arr, axis_names=("chan", "vis"))
