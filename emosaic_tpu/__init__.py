"""emosaic_tpu — a JAX photomosaic framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the `emosaic`
reference (pepeiborra/emosaic): tile-library analysis, nearest-tile matching
(exact Manhattan/L1 color distance), mosaic composition with tint blending,
no-repeat assignment, statistics, HTML widget output, and a flag-service
backend.

Architecture:

- Host layer (Python + C++ `native/`): image decode/encode, directory walking,
  EXIF, white-border trim + crop + resize tile preparation, the two persistent
  caches (`.emosaic_{N}to1[_cropped]` analysis cache and the content-hash
  prepared-tile cache), CLI, stats/HTML generation, and the sequential greedy
  no-repeat assignment engine.
- Device layer (JAX/XLA/Pallas on a GPU): batched palette analysis (box-mean
  reduction over the whole tile stack at once), fused L1 distance + argmin
  matching — a register-tiled Pallas-Triton kernel (low N), fused XLA
  distance stripes (high N), or an exact separable min-plus distance
  transform over the 256^3 RGB lattice (N=1) — top-k candidate generation,
  and gather-based mosaic composition with fused tint alpha-blend.
  `ops/backend.py` picks each route by device capability.
- Parallel layer: `jax.sharding.Mesh` + `shard_map` sharding of the source
  block axis (data parallelism) and the tile-library axis (model parallelism)
  with associative (min, argmin) combining over the device interconnect.

Reference parity notes are cited inline as `file:line` under /root/reference.
"""

__version__ = "0.1.0"

import os as _os


def compile_cache_dir() -> str:
    """Where compiled programs persist: `JAX_COMPILATION_CACHE_DIR` when
    set (JAX reads it itself), else a fixed `.jax_cache/` in the checkout.
    A fixed path matters: the cache key includes it."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


# Persistent XLA compilation cache across processes. Opt out with
# EMOSAIC_NO_COMPILE_CACHE=1 (the prep workers do, and stay jax-free).
if not _os.environ.get("EMOSAIC_NO_COMPILE_CACHE"):
    import jax as _jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from emosaic_tpu.modes import MODE_TO_N, Mode  # noqa: F401
