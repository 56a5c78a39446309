"""Device mesh construction and sharding helpers.

Axes:
  "batch" — data parallelism over frames/sequences (frontend detection,
            matching and per-frame geometry are embarrassingly parallel
            across frames; only pose CHAINING is serial).
  "lm"    — landmark/observation sharding for distributed bundle
            adjustment (the keyframe/map-block partitioning of
            SURVEY.md §7 step 8; camera states stay replicated and
            camera-side reductions ride psum).

The cards of one host are joined all to all (NVLink), so the mesh is a
plain reshape of the device list that follows the algorithm.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, lm_axis: Optional[int] = None
              ) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if lm_axis is None:
        # favour landmark sharding (BA is the communication-heavy stage)
        lm_axis = 1
        for cand in (4, 2):
            if n % cand == 0 and n >= cand:
                lm_axis = cand
                break
    grid = np.array(devs).reshape(n // lm_axis, lm_axis)
    return Mesh(grid, axis_names=("batch", "lm"))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading axis over 'batch', replicate the rest."""
    return NamedSharding(mesh, P("batch", *([None] * (ndim - 1))))


def lm_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, P("lm", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
