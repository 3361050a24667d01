"""Exact L1 nearest-tile lookup table over the 256^3 RGB lattice (mode 1).

Device replacement for per-query kd-tree search (rendering.rs:192
`nearest_one::<Manhattan>`) in 1to1 mode, where queries are single RGB
pixels: precompute, for *every* possible color, the nearest library row
under L1 — then matching any number of source blocks is a single gather.

The table is built with an exact separable min-plus (chamfer) distance
transform: L1 distance factorizes across axes, and each 1D transform
`d[i] = min_j f[j] + |i-j|` is computed with log-doubling relaxation passes
(steps 1,2,4,...,128 in both directions cover all offsets <= 255 exactly).
Each lattice cell carries a packed int32 key `(dist << ROW_BITS) | row`, so
every `min` is lexicographic on (distance, library row) — identical
tie-breaking (lowest row wins) to `emosaic_tpu.ops.distance.l1_argmin`.

Cost: ~50 vectorized passes over a 64 MiB lattice, after which gigapixel
matching is memory-bound gather only (neither measured on the H100 yet).
"""

from __future__ import annotations

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np

ROW_BITS = 21
ROW_MASK = (1 << ROW_BITS) - 1
#: max library rows (2T) a LUT key can address — far above the reference's
#: 32767-tile cap (main.rs:791, tileset.rs:178-183).
MAX_ROWS = ROW_MASK
_INF = np.int32(2**31 - 1)


def _shifted(lattice: jax.Array, axis: int, step: int, forward: bool) -> jax.Array:
    """Shift along `axis` by `step`, filling vacated cells with INF."""
    pad = [(0, 0)] * 3
    if forward:
        pad[axis] = (step, 0)
        sl = [slice(None)] * 3
        sl[axis] = slice(0, 256)
        return jnp.pad(lattice, pad, constant_values=_INF)[tuple(sl)]
    pad[axis] = (0, step)
    sl = [slice(None)] * 3
    sl[axis] = slice(step, 256 + step)
    return jnp.pad(lattice, pad, constant_values=_INF)[tuple(sl)]


@jax.jit
def _build_l1_lut_jit(lib: jax.Array) -> jax.Array:
    lib = lib.reshape(-1, 3)
    l = lib.shape[0]
    rows = jnp.arange(l, dtype=jnp.int32)  # key with dist=0
    lattice = jnp.full((256, 256, 256), _INF, dtype=jnp.int32)
    r, g, b = lib[:, 0], lib[:, 1], lib[:, 2]
    # lattice axes are [b, g, r]: the flat index b*65536 + g*256 + r equals
    # a little-endian-packed RGBX u32 masked to 24 bits, so packed sources
    # index the table without any per-channel unpacking
    # scatter-min: duplicate colors keep the lowest row (lexicographic key)
    lattice = lattice.at[b, g, r].min(rows)

    for axis in range(3):
        step = 1
        while step <= 128:
            delta = np.int32(step << ROW_BITS)
            fwd = _shifted(lattice, axis, step, True)
            bwd = _shifted(lattice, axis, step, False)
            # guard the INF sentinel against overflow before adding the cost
            fwd = jnp.where(fwd == _INF, _INF, fwd + delta)
            bwd = jnp.where(bwd == _INF, _INF, bwd + delta)
            lattice = jnp.minimum(lattice, jnp.minimum(fwd, bwd))
            step *= 2
    return lattice


# Content-keyed cache of built LUTs. The distance-transform build is a
# real device cost (24 shifted-min sweeps over the 16.7M-entry lattice),
# and resident callers (emosaic_tpu.serve, repeat CLI runs in one
# process) re-match against the SAME library every request — rebuilding
# the table per render was pure waste there. Keyed by the library bytes
# (md5 of ~600 KB at the 2M-row cap is microseconds next to the build);
# each cached entry holds 64 MB of device HBM, so the cap stays tiny.
# EMOSAIC_LUT_CACHE=0 disables.
_LUT_CACHE: "dict[tuple[bytes, int], jax.Array]" = {}
_LUT_CACHE_MAX = 2


def build_l1_lut(lib) -> jax.Array:
    """Build the [256,256,256] int32 packed (dist, row) nearest-row table.

    Results are cached per library content (see _LUT_CACHE): a resident
    server's warm mode-1 requests skip the rebuild entirely.

    Args:
      lib: [L, 3] uint8 library matrix (mode-1 `build_library` output;
        L = 2T with flip rows — note for N=1 a flip is an identity, the
        reference still indexes both orientations, tileset.rs:178-188).
    """
    lib = np.asarray(lib, dtype=np.uint8)
    if lib.ndim != 2 or lib.shape[1] != 3:
        raise ValueError(f"LUT requires [L,3] mode-1 library, got {lib.shape}")
    if lib.shape[0] == 0:
        raise ValueError("empty library")
    if lib.shape[0] > MAX_ROWS:
        raise ValueError(f"library has {lib.shape[0]} rows > LUT cap {MAX_ROWS}")
    use_cache = os.environ.get("EMOSAIC_LUT_CACHE", "1") != "0"
    if use_cache:
        key = (hashlib.md5(lib.tobytes()).digest(), lib.shape[0])
        hit = _LUT_CACHE.get(key)
        # a cached device buffer dies with its backend (jax.clear_caches /
        # backend teardown deletes it); fall through to a rebuild then
        if hit is not None and not hit.is_deleted():
            return hit
    # int32 flat boundary (channels unpacked inside the jit)
    lut = _build_l1_lut_jit(jnp.asarray(lib.reshape(-1).astype(np.int32)))
    if use_cache:
        while len(_LUT_CACHE) >= _LUT_CACHE_MAX:
            _LUT_CACHE.pop(next(iter(_LUT_CACHE)))
        _LUT_CACHE[key] = lut
    return lut


def pack_rgb(blocks: np.ndarray) -> np.ndarray:
    """Host-pack [B, 3] uint8 RGB into the LUT's flat int32 index
    (b*65536 + g*256 + r — the little-endian RGBX order)."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    return (
        blocks[:, 2].astype(np.int32) * 65536
        + blocks[:, 1].astype(np.int32) * 256
        + blocks[:, 0].astype(np.int32)
    )


#: row width for the match gather: fetch 8 entries (one 32-byte row) per
#: index and select the target lane with fused vector math. Chosen for an
#: index-rate-bound gather engine; a plain 1-wide gather is not yet
#: measured against it on the H100 (ROADMAP Speed 6).
_ROW_W = 8
_ROW_SHIFT = 3


@jax.jit
def _lut_match_packed_jit(idx: jax.Array, lut: jax.Array):
    tab = lut.reshape(-1, _ROW_W)
    rows = tab[idx >> _ROW_SHIFT]  # [B, 8] row gather
    lane = (idx & (_ROW_W - 1))[:, None]
    j = jnp.arange(_ROW_W, dtype=jnp.int32)[None, :]
    key = jnp.where(j == lane, rows, 0).sum(axis=1, dtype=jnp.int32)
    return key >> ROW_BITS, key & ROW_MASK


def lut_match_packed(idx, lut) -> tuple[jax.Array, jax.Array]:
    """Match pre-packed flat indices (see `pack_rgb`; device arrays of
    little-endian RGBX & 0xFFFFFF also qualify)."""
    return _lut_match_packed_jit(jnp.asarray(idx, jnp.int32), lut)


def lut_match(blocks, lut) -> tuple[jax.Array, jax.Array]:
    """Match [B, 3] uint8 blocks via the LUT.

    Returns (dist [B] int32, row [B] int32) — identical to
    `l1_argmin(blocks, lib)` but O(1) per query. Packing happens on the
    host (numpy runs it at memory speed; the device would pay strided
    per-channel extraction).
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    if blocks.ndim != 2 or blocks.shape[1] != 3:
        raise ValueError(f"LUT match requires [B,3] blocks, got {blocks.shape}")
    return _lut_match_packed_jit(jnp.asarray(pack_rgb(blocks)), lut)
