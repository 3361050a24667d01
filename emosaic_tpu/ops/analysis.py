"""Palette analysis kernels: batched box-mean color reduction.

Replaces the reference's per-tile scalar loops (analysis.rs:5-20 `analyse`,
color.rs:14-42 `average_color`, analysis.rs:23-36 `get_img_colors`) with one
batched reduction over the whole tile stack.

Exact-parity semantics preserved:
- Box geometry: a sqrt(N) x sqrt(N) grid of `floor(w/dim) x floor(h/dim)`
  boxes anchored at `(col*bw, row*bh)`; trailing pixels beyond `dim*bw` /
  `dim*bh` are dropped (analysis.rs:6-14).
- Per-box mean uses *truncating* integer division (color.rs:37-39).
- Cell order is row-major (cell i -> row i//dim, col i%dim, analysis.rs:12-13).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("h", "w", "dim"))
def _analyse_batch_2d(tiles2d: jax.Array, *, h: int, w: int, dim: int) -> jax.Array:
    """tiles2d [T, h*w*3] u8 -> palettes [T, N*3] u8 (2D jit boundaries,
    channels interleaved in the minor dim)."""
    t = tiles2d.shape[0]
    bh = h // dim
    bw = w // dim
    # Drop trailing pixels (analysis.rs:7-8 floor), then box-reduce.
    x = tiles2d.reshape(t, h, w, 3)[:, : dim * bh, : dim * bw, :].astype(
        jnp.int32
    )
    x = x.reshape(t, dim, bh, dim, bw, 3)
    sums = x.sum(axis=(2, 4))  # [T, dim, dim, 3]
    counts = bh * bw
    means = sums // counts  # truncating division (color.rs:37-39)
    return means.astype(jnp.uint8).reshape(t, dim * dim * 3)


def _analyse_batch_jit(tiles: jax.Array, dim: int) -> jax.Array:
    """Traceable core on [T, h, w, 3]; usable inside shard_map/jit (nested
    jit inlines)."""
    t, h, w = tiles.shape[0], tiles.shape[1], tiles.shape[2]
    if h // dim == 0 or w // dim == 0:
        raise ValueError(f"tile {h}x{w} smaller than {dim}x{dim} grid")
    if (h // dim) * (w // dim) > (2**31 - 1) // 255:
        # the box sum accumulates in int32; a >8.4M-px box would wrap
        # silently. Unreachable via the CLI (tile size is capped at
        # 1024), but this is a public op.
        raise ValueError(
            f"box {h // dim}x{w // dim} too large: per-channel sums exceed "
            "int32 (max ~8.4M pixels per box)"
        )
    out = _analyse_batch_2d(tiles.reshape(t, h * w * 3), h=h, w=w, dim=dim)
    return out.reshape(t, dim * dim, 3)


def analyse_batch(tiles, dim: int) -> jax.Array:
    """Analyse a stack of tiles into per-cell average colors.

    Args:
      tiles: `[T, h, w, 3]` uint8 tile images (all the same size).
      dim: grid edge (sqrt of the mode's N).

    Returns:
      `[T, N, 3]` uint8 palettes, cells in row-major order.
    """
    tiles = np.asarray(tiles, dtype=np.uint8)
    if tiles.ndim != 4 or tiles.shape[-1] != 3:
        raise ValueError(f"expected [T,h,w,3], got {tiles.shape}")
    t, h, w = tiles.shape[0], tiles.shape[1], tiles.shape[2]
    if h // dim == 0 or w // dim == 0:
        raise ValueError(f"tile {h}x{w} smaller than {dim}x{dim} grid")
    if (h // dim) * (w // dim) > (2**31 - 1) // 255:
        # the box sum accumulates in int32; a >8.4M-px box would wrap
        # silently. Unreachable via the CLI (tile size is capped at
        # 1024), but this is a public op.
        raise ValueError(
            f"box {h // dim}x{w // dim} too large: per-channel sums exceed "
            "int32 (max ~8.4M pixels per box)"
        )
    out = _analyse_batch_2d(
        jnp.asarray(tiles.reshape(t, -1)), h=h, w=w, dim=dim
    )
    return out.reshape(t, dim * dim, 3)


def analyse_one(tile, dim: int) -> np.ndarray:
    """Analyse a single `[h, w, 3]` image (reference `analyse`, analysis.rs:5)."""
    tile = np.asarray(tile, dtype=np.uint8)
    return np.asarray(analyse_batch(tile[None], dim))[0]


@functools.partial(jax.jit, static_argnames=("h", "w", "dim"))
def _source_blocks_2d(img2d: jax.Array, *, h: int, w: int, dim: int) -> jax.Array:
    """img2d [H, W*3] u8 -> blocks [nby*nbx, 3N] u8."""
    nby, nbx = h // dim, w // dim
    x = img2d.reshape(nby, dim, nbx, dim, 3)
    # Block-major (y, x), then within-block row-major pixels, then RGB:
    # matches Tile::coords flattening of get_img_colors output
    # (analysis.rs:23-36 row-major block pixels; tile.rs:104-120).
    return jnp.transpose(x, (0, 2, 1, 3, 4)).reshape(nby * nbx, dim * dim * 3)


def source_blocks(img, dim: int) -> jax.Array:
    """Split a source image into flattened per-block color vectors.

    Args:
      img: `[H, W, 3]` uint8 source (H, W divisible by `dim` — the driver
        enforces this like main.rs:603-611).
      dim: block edge in source pixels.

    Returns:
      `[nby*nbx, 3N]` uint8, blocks in row-major (y-major) order; each block
      is the raw dim x dim source pixels row-major, RGB-interleaved — exactly
      the reference's query coordinates (analysis.rs:23-36 + tile.rs:104-120).
    """
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected [H,W,3], got {img.shape}")
    if img.shape[0] % dim or img.shape[1] % dim:
        raise ValueError(f"dims {img.shape[:2]} not divisible by {dim}")
    h, w = img.shape[0], img.shape[1]
    return _source_blocks_2d(
        jnp.asarray(img.reshape(h, w * 3)), h=h, w=w, dim=dim
    )
