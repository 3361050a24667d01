"""Capability routing: which implementation each device-side choice takes.

The exact L1 matchers have several implementations with identical results
(equal distance, lowest library row on ties). Which one runs depends on
what the process's device can compile and what measured fastest there,
so the decisions and their measured thresholds live here, in one table,
instead of as platform tests scattered through the kernels:

- ``gpu``: the dense argmin takes the Pallas-Triton kernel up to
  `TRITON_MAX_D`, the certified adaptive scorer up to
  `ADAPTIVE_MAX_D["gpu"]`, and the chunked scan above that; top-k at
  scale takes the adaptive scorer up to the same D and the two-level
  scorer above it — each the fastest exact route measured on an H100 at
  the flagship widths (docs/KERNELS.md has the timings);
- ``cpu``: the plain XLA scan the tests use as their oracle;
- anything else raises: no route silently runs the oracle, a reference
  or the Pallas interpreter on an accelerator it was not measured on.

Device memory budgets are derived here too, from the device's own
``memory_stats()["bytes_limit"]``.
"""

from __future__ import annotations

import os

import jax

#: platforms with a measured route table
PLATFORMS = ("cpu", "gpu")

#: widest feature dim routed to the Triton argmin kernel (modes 2-8). The
#: kernel is timed on the H100 up to D = 192; wider dims take the routes
#: measured there
TRITON_MAX_D = 256
#: the Triton kernel addresses its [D, Bp] query and [D, Lp] library
#: operands through 32-bit offsets; operands this large take the scan
TRITON_INDEX_LIMIT = 2**31
#: widest D at which the certified adaptive scorer runs at scale (B * L
#: past `ADAPTIVE_GATE_ELEMS`), per platform; above it the argmin takes
#: the scan and top-k the direct two-level scorer. gpu: on an H100 at
#: B = 16384, L = 65534 (clustered data), D = 768, the adaptive scorer
#: took 116 ms at k = 1 against 1036 ms for stripes and 1216 ms for the
#: scan, and 207 ms at k = 512 (no-repeat) against 1241 ms for the
#: two-level scorer; at D = 3072 its programs did not finish compiling
#: within ten minutes, and the scan (1724 ms) beat stripes (4085 ms).
#: cpu: the gate the CPU tests were written against
ADAPTIVE_MAX_D = {"cpu": 256, "gpu": 768}
ADAPTIVE_GATE_ELEMS = 10**7

#: share of the device's `bytes_limit` a resident match library may take:
#: the certified scorers keep the library, its coarse projection, the
#: survivor lists and a stripe workspace on the device at once, and the
#: streamed scorer holds two banks while it prefetches
LIB_FRACTION = 0.4
#: share of `bytes_limit` for the prepared-tile stack: the composite
#: uploads it with a mirrored copy (twice the stack) beside the library
STACK_FRACTION = 0.125


class UnsupportedPlatform(RuntimeError):
    """The device's platform has no measured route table."""


def platform() -> str:
    """Platform of the process's first device ("cpu", "gpu", ...)."""
    return jax.devices()[0].platform


def check_platform(plat: str) -> str:
    if plat not in PLATFORMS:
        raise UnsupportedPlatform(
            f"no measured route table for platform {plat!r} "
            f"(supported: {', '.join(PLATFORMS)})"
        )
    return plat


def argmin_route(plat: str, d: int, span: int = 0) -> str:
    """Route of the exact dense L1 argmin for feature dim `d`.

    `span` is the element count of the Triton kernel's larger padded
    operand for this input (`distance._triton_span`). Returns one of
    "triton" (Pallas-Triton kernel), "adaptive" (the certified
    coarse-to-fine scorer at k = 1, which reroutes itself to the direct
    scorer on data it cannot prune) or "xla" (the chunked scan, which is
    also the correctness oracle)."""
    check_platform(plat)
    if plat == "cpu":
        return "xla"
    if d <= TRITON_MAX_D:
        # past the kernel's 32-bit offsets the scan, the faster XLA route
        # at D = 12 and 48
        return "triton" if span < TRITON_INDEX_LIMIT else "xla"
    if d <= ADAPTIVE_MAX_D[plat]:
        return "adaptive"
    return "xla"


def topk_route(plat: str, d: int, elems: int) -> str:
    """Scorer of the exact top-k for `elems` = B * L query-row pairs:
    "adaptive" (certified coarse-to-fine; it still reroutes itself on
    shapes or data it cannot prune) or "twolevel" (the direct two-level
    scorer). Shapes at or under `ADAPTIVE_GATE_ELEMS` always try the
    adaptive scorer, so the CPU tests keep exercising it at every D."""
    check_platform(plat)
    if elems <= ADAPTIVE_GATE_ELEMS or d <= ADAPTIVE_MAX_D[plat]:
        return "adaptive"
    return "twolevel"


def bytes_limit(device=None) -> int:
    """Memory the device's allocator may hand out (default: this
    process's first local device — a multi-process run cannot read
    another process's devices). CPU devices report no `memory_stats`;
    their memory is the host's RAM."""
    device = device or jax.local_devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if limit:
        return int(limit)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def device_lib_bytes(device=None) -> int:
    """Resident-library budget: `EMOSAIC_DEVICE_LIB_BYTES` when set, else
    `LIB_FRACTION` of the device's `bytes_limit`."""
    env = os.environ.get("EMOSAIC_DEVICE_LIB_BYTES")
    if env:
        return int(env)
    return int(bytes_limit(device) * LIB_FRACTION)


def device_stack_bytes(device=None) -> int:
    """Default cap on the dense prepared-tile stack: `STACK_FRACTION` of
    the device's `bytes_limit` (past it the composite streams tiles from
    the disk cache)."""
    return int(bytes_limit(device) * STACK_FRACTION)
