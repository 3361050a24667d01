"""Seeded synthetic tile libraries and sources (clustered colour + texture).

Real photo libraries are colour-structured: each tile has a dominant
colour and a texture around it, and a source image's blocks sit close to
a few library tiles. The model here keeps that structure, which is what
the certified adaptive scorer and the matcher routes are tuned for:

- tile = one base colour (each channel in [0, 200], so no pixel is white
  enough for the prep's border trim) plus uniform texture in [-10, 10];
- source block = a random library tile plus uniform noise in [-6, 6].

Everything is generated from `seed` with numpy, in bulk.
"""

from __future__ import annotations

import numpy as np

#: channel ceiling of a base colour (the prep trims pixels > 240)
_BASE_MAX = 200
_TEXTURE = 10
_NOISE = 6


def clustered_tiles(t: int, size: int, seed: int) -> np.ndarray:
    """[t, size, size, 3] u8 tile images."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, _BASE_MAX + 1, (t, 1, 1, 3), dtype=np.int16)
    tex = rng.integers(-_TEXTURE, _TEXTURE + 1, (t, size, size, 3), np.int16)
    return np.clip(base + tex, 0, 255).astype(np.uint8)


def clustered_source(
    tiles: np.ndarray, grid_h: int, grid_w: int, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """A [grid_h * s, grid_w * s, 3] u8 source built from random tiles plus
    noise (s = tile side), and the [grid_h, grid_w] tile indices used."""
    rng = np.random.default_rng(seed)
    t, s = tiles.shape[0], tiles.shape[1]
    pick = rng.integers(0, t, (grid_h, grid_w))
    img = tiles[pick].astype(np.int16)  # [gh, gw, s, s, 3]
    img += rng.integers(-_NOISE, _NOISE + 1, img.shape, dtype=np.int16)
    img = img.transpose(0, 2, 1, 3, 4).reshape(grid_h * s, grid_w * s, 3)
    return np.clip(img, 0, 255).astype(np.uint8), pick


def clustered_vectors(
    b: int, l: int, d: int, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """Palette-space form of the same model: ([b, d] blocks, [l, d]
    library) u8, with d a multiple of 3 (interleaved RGB cells)."""
    if d % 3:
        raise ValueError(f"d must be a multiple of 3, got {d}")
    rng = np.random.default_rng(seed)
    base = rng.integers(0, _BASE_MAX + 1, (l, 1, 3), dtype=np.int16)
    lib = base + rng.integers(
        -_TEXTURE, _TEXTURE + 1, (l, d // 3, 3), dtype=np.int16
    )
    lib = np.clip(lib.reshape(l, d), 0, 255).astype(np.uint8)
    pick = rng.integers(0, l, b)
    blocks = lib[pick].astype(np.int16) + rng.integers(
        -_NOISE, _NOISE + 1, (b, d), dtype=np.int16
    )
    return np.clip(blocks, 0, 255).astype(np.uint8), lib
