"""Device mesh construction.

The mosaic workload has two natural parallel axes (SURVEY.md section 2.6):
- "data": the source-block axis — pure data parallelism over independent
  argmin problems (the device equivalent of the reference's rayon block
  parallelism, rendering.rs:68-70);
- "model": the tile-library axis — each shard searches its slice of the
  library and partial (min, argmin) results are combined over the
  interconnect (the tensor-parallel analogue).

The mesh follows the algorithm alone: on a host whose cards are joined
all to all (NVLink), any layout of the devices is as good as another.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: int | None = None,
    model: int | None = None,
    devices=None,
) -> Mesh:
    """Build a ("data", "model") mesh over the available devices.

    Args:
      n_devices: number of devices (default: all).
      model: library-axis shards (default: 1 — pure data parallelism;
        library sharding pays an all-gather of per-shard winners,
        worth it only when the library shard doesn't fit or the distance
        work dominates).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    model = model or 1
    if n_devices % model:
        raise ValueError(f"{n_devices} devices not divisible by model={model}")
    data = n_devices // model
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))
