"""Multi-chip build of the exact L1 nearest-tile LUT (mode 1).

Shards the 256^3 RGB lattice of `ops.lut.build_l1_lut` over the mesh along
the b (outermost) axis and runs the separable min-plus (chamfer) distance
transform per shard. Device counterpart of the kd-tree build the
reference performs once per render (tileset.rs:178-190) — here scaled over
the interconnect for multi-device pipelines where each device keeps a
lattice shard resident.

Algorithm: instead of exchanging halo planes per log-doubling relaxation
pass (18 passes x up-to-128-plane halos along the sharded axis), each 1D
min-plus transform `d[i] = min_j f[j] + |i-j|` is computed exactly as a
forward + backward *scan*:

    fwd[i] = min_{j<=i} (f[j] - j*u) + i*u
    bwd[i] = min_{j>=i} (f[j] + j*u) - i*u
    d[i]   = min(fwd[i], bwd[i])        (u = 1 << ROW_BITS)

The subtraction/addition is linear in the position, so each scan is a
`lax.cummin` over position-adjusted packed keys — and across shards it is
a classic parallel prefix: local cummin + one all_gather of per-shard
carry planes + a lexicographic fold. Keys pack (distance, row) exactly as
in ops/lut.py, so every min is lexicographic and the result is
bit-identical to `build_l1_lut`, including lowest-row tie-breaks.

Communication per build: 2 all_gathers of [n, 256, 256] i32 carry planes
(256 KB per shard per direction) — independent of library size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from emosaic_tpu.ops.lut import MAX_ROWS, ROW_BITS, _INF

_U = np.int32(1 << ROW_BITS)


def _adj(lat: jax.Array, delta: jax.Array, sign: int) -> jax.Array:
    """Position-adjust packed keys, keeping the INF sentinel exact.

    Real keys stay < _INF after adjustment: max real key is
    765<<21 + row < 1.61e9 and |delta| <= 255<<21 = 5.35e8, so
    key + delta <= 2.15e9 < 2^31 (no overflow) and key - delta > -2^31.
    """
    return jnp.where(lat == _INF, _INF, lat + sign * delta)


def _axis_transform_local(lat: jax.Array, axis: int) -> jax.Array:
    """Exact 1D min-plus transform along a full (unsharded) 256 axis."""
    shape = [1, 1, 1]
    shape[axis] = lat.shape[axis]
    pos = (jnp.arange(lat.shape[axis], dtype=jnp.int32) * _U).reshape(shape)
    fwd = jax.lax.cummin(_adj(lat, pos, -1), axis=axis)
    fwd = _adj(fwd, pos, +1)
    bwd = jax.lax.cummin(_adj(lat, pos, +1), axis=axis, reverse=True)
    bwd = _adj(bwd, pos, -1)
    return jnp.minimum(fwd, bwd)


def _axis0_transform_sharded(lat: jax.Array, axis_name: str, s: int) -> jax.Array:
    """Exact 1D min-plus transform along the sharded axis 0.

    lat: [S, 256, 256] local slab; global position of local plane i is
    me*S + i. Parallel prefix: local cummin over globally-adjusted keys,
    then fold the other shards' boundary carries (one all_gather each
    direction).
    """
    me = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    pos_g = ((me * s + jnp.arange(s, dtype=jnp.int32)) * _U).reshape(s, 1, 1)

    # forward: min over j <= i of f[j] - j*u
    fwd_adj = jax.lax.cummin(_adj(lat, pos_g, -1), axis=0)
    carries_f = jax.lax.all_gather(fwd_adj[-1], axis_name)  # [n, 256, 256]
    shard_ids = jnp.arange(n, dtype=jnp.int32).reshape(n, 1, 1)
    prefix = jnp.min(
        jnp.where(shard_ids < me, carries_f, _INF), axis=0
    )  # min over shards strictly before me
    fwd = _adj(jnp.minimum(fwd_adj, prefix[None]), pos_g, +1)

    # backward: min over j >= i of f[j] + j*u
    bwd_adj = jax.lax.cummin(_adj(lat, pos_g, +1), axis=0, reverse=True)
    carries_b = jax.lax.all_gather(bwd_adj[0], axis_name)
    suffix = jnp.min(jnp.where(shard_ids > me, carries_b, _INF), axis=0)
    bwd = _adj(jnp.minimum(bwd_adj, suffix[None]), pos_g, -1)
    return jnp.minimum(fwd, bwd)


def sharded_build_l1_lut(lib, mesh: Mesh) -> np.ndarray:
    """Build the [256,256,256] packed (dist, row) LUT over the mesh.

    Bit-identical to `ops.lut.build_l1_lut` (asserted in
    tests/test_sharding.py). Uses the flattened mesh as one 1-D "lut"
    axis; the lattice b axis must be divisible by the device count.

    Args:
      lib: [L, 3] uint8 mode-1 library matrix (build_library output).
    Returns:
      [256, 256, 256] int32 lattice (host numpy), sharded during build.
    """
    lib = np.asarray(lib, dtype=np.uint8)
    if lib.ndim != 2 or lib.shape[1] != 3:
        raise ValueError(f"LUT requires [L,3] mode-1 library, got {lib.shape}")
    if not 0 < lib.shape[0] <= MAX_ROWS:
        raise ValueError(f"library size {lib.shape[0]} out of range")
    devs = mesh.devices.reshape(-1)
    n = len(devs)
    if 256 % n:
        raise ValueError(f"lattice axis 256 not divisible by {n} devices")
    s = 256 // n
    ring = Mesh(devs, axis_names=("lut",))

    @functools.partial(
        jax.jit,
        in_shardings=NamedSharding(ring, P(None)),
        out_shardings=NamedSharding(ring, P("lut", None, None)),
    )
    def run(lib_flat):
        def body(lib_local):
            me = jax.lax.axis_index("lut")
            l3 = lib_local.reshape(-1, 3)
            rows = jnp.arange(l3.shape[0], dtype=jnp.int32)
            # lattice axes [b, g, r] (ops/lut.py layout); this shard owns
            # b in [me*s, (me+1)*s)
            r, g, b = l3[:, 0], l3[:, 1], l3[:, 2]
            b_loc = b - me * s
            own = (b_loc >= 0) & (b_loc < s)
            lat = jnp.full((s, 256, 256), _INF, dtype=jnp.int32)
            lat = lat.at[jnp.clip(b_loc, 0, s - 1), g, r].min(
                jnp.where(own, rows, _INF)
            )
            lat = _axis_transform_local(lat, 1)  # g
            lat = _axis_transform_local(lat, 2)  # r
            lat = _axis0_transform_sharded(lat, "lut", s)  # b (halo carries)
            return lat

        return jax.shard_map(
            body,
            mesh=ring,
            in_specs=P(None),
            out_specs=P("lut", None, None),
            check_vma=False,
        )(lib_flat)

    out = run(jnp.asarray(lib.reshape(-1).astype(jnp.int32)))
    # fetch, not device_get: under multi-controller the "lut"-sharded
    # output spans non-addressable devices (plain device_get one-process)
    from emosaic_tpu.parallel.distributed import fetch

    return fetch(out)
