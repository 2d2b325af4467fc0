"""Device-mesh helpers.

The reference has no distributed layer at all (SURVEY.md §2.4: its only
parallelism is OpenMP threads). This framework's scale-out axis is a 1-D
`jax.sharding.Mesh` over which posting lists are sharded by centroid range;
queries fan out replicated and top-k results merge with `lax.all_gather`
(NCCL over NVLink on a multi-GPU host, which joins the cards all to all, so
the mesh follows the algorithm alone).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


SHARD_AXIS = "shard"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the first n_devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (SHARD_AXIS,))
