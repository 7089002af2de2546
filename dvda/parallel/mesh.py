"""Device-mesh construction for multi-chip decode.

The reference is single-threaded end to end (SURVEY §2: no parallelism of
any kind); scaling in the rebuild comes from JAX SPMD over a mesh:

* ``dp`` (data parallel) — independent work items: restart chains during
  filtering, frames during rematrixing, tracks for full-disc batches;
* ``tp`` (tensor parallel) — the channel axis: channels filter
  independently and only meet at the rematrix, so a channel-sharded filter
  followed by an XLA-inserted all-gather over ``tp`` mirrors the classic
  tensor-parallel pattern.

The GPUs of a host reach each other all to all (NVLink), so the grid's
shape follows the algorithm alone, not a device topology.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "AXIS_DATA", "AXIS_CHANNEL"]

AXIS_DATA = "dp"
AXIS_CHANNEL = "tp"


def make_mesh(n_devices: int | None = None, tp: int | None = None) -> Mesh:
    """Build a 2D (dp × tp) mesh over the first ``n_devices`` devices
    (default: all).  Asking for more devices than JAX sees raises.
    ``tp`` defaults to 2 when it divides the count (channels pair
    naturally), else 1.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"make_mesh({n_devices}): only {len(devices)} "
                         f"{devices[0].platform} devices are visible")
    devices = devices[:n_devices]
    if tp is None or n_devices % tp != 0:
        tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    dp = n_devices // tp
    grid = np.array(devices).reshape(dp, tp)
    return Mesh(grid, (AXIS_DATA, AXIS_CHANNEL))
