"""Multi-process (multi-controller) SPMD support.

On a multi-host cluster each host runs one copy of the program over its
local devices and `jax.distributed.initialize()` joins them into one
global runtime: `jax.devices()` then spans every device in the cluster
while `jax.local_devices()` stays host-local, and the ("data", "model")
mesh from `parallel.mesh.make_mesh` simply becomes a cluster-wide mesh — the
sharded kernels in `parallel.sharded` are written against the global
mesh and do not change. What DOES change at process boundaries is host
I/O: a global `jax.Array` is only partially addressable from any one
process, so fetching results must ride a collective (`fetch` below)
instead of `jax.device_get`.

The same multi-controller model runs here over plain CPU processes (the
gloo collectives backend), which is how CI validates it without a
cluster: `tools/cpu_multiproc_dryrun.py` runs the production sharded
scorers across two OS processes x four virtual devices each, where every
`psum`/`all_gather` in the kernels genuinely crosses a process boundary,
and bit-compares against the single-process oracles.

Reference analogue: none — the reference is single-host rayon
parallelism (rendering.rs:68-70) with a hard 32 767-tile cap. This is
the multi-host axis of the scale-out design (data/model sharding within
a host is `parallel.sharded`; this module adds the multi-host layer
those meshes ride on). One process drives all the cards of one host.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join this process into a multi-controller JAX runtime.

    On clusters whose environment JAX can auto-detect, call with no
    arguments. Otherwise (CPU validation, manual clusters), pass all
    three or set the
    environment: EMOSAIC_COORDINATOR (host:port), EMOSAIC_NUM_PROCESSES,
    EMOSAIC_PROCESS_ID. Idempotent: a second call is a no-op once the
    runtime is live (jax raises on re-initialize; callers like the CLI
    and serve can both request it).
    """
    # only inspect the distributed client state — jax.process_count()
    # would itself initialize the XLA backend, after which
    # jax.distributed.initialize refuses to run
    if _initialized():
        return
    coordinator = coordinator or os.environ.get("EMOSAIC_COORDINATOR")
    if num_processes is None and "EMOSAIC_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["EMOSAIC_NUM_PROCESSES"])
    if process_id is None and "EMOSAIC_PROCESS_ID" in os.environ:
        process_id = int(os.environ["EMOSAIC_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        # cluster auto-detection; single-process hosts
        # without a cluster env just stay single-controller
        try:
            jax.distributed.initialize()
        except Exception as e:  # noqa: BLE001
            if os.environ.get("EMOSAIC_DISTRIBUTED"):
                # the user explicitly demanded a multi-controller run
                # (CLI EMOSAIC_DISTRIBUTED=1): silently degrading to
                # single-controller would make every host render the
                # full image independently — fail loudly instead
                raise RuntimeError(
                    "EMOSAIC_DISTRIBUTED=1 but the multi-controller "
                    "runtime could not initialize (no cluster "
                    "environment?) — set EMOSAIC_COORDINATOR, "
                    "EMOSAIC_NUM_PROCESSES, EMOSAIC_PROCESS_ID for "
                    "manual clusters"
                ) from e
            return  # opportunistic call, no cluster env: stay single
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def _initialized() -> bool:
    state = getattr(jax._src.distributed, "global_state", None)
    return getattr(state, "client", None) is not None


def is_multiprocess() -> bool:
    """True when this process is part of a multi-controller runtime."""
    return jax.process_count() > 1


def is_rank0() -> bool:
    """True in single-controller processes and on global rank 0.

    The CLI gates user-facing file writes (output image, stats, HTML) on
    this under EMOSAIC_DISTRIBUTED, the standard multi-host discipline: every
    rank computes the same SPMD program, one rank does host I/O."""
    return jax.process_index() == 0


def fetch(x) -> np.ndarray:
    """`device_get` that survives multi-controller sharding.

    A global `jax.Array` sharded over a cluster-wide mesh is only partially
    addressable from any one process; `jax.device_get` refuses it. This
    all-gathers the array to every process first (one collective over
    the interconnect — or gloo on the CPU validation path) and returns host
    numpy. Fully-addressable arrays (single-process, or replicated
    outputs) take the plain `device_get` path, so single-controller
    behavior and cost are unchanged.
    """
    if isinstance(x, np.ndarray):
        return x
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(jax.device_get(x))
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
