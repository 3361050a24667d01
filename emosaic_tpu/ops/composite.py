"""Mosaic composition: device-side gather of tile images + fused tint blend.

Replaces the reference's per-block `imageops::replace/overlay` placement
loops (rendering.rs:76-99, :346-381) with a gather over the prepared-tile
stack, and the host-side RGBA tint overlay (main.rs:447-465) with a fused
alpha blend.

Flip handling mirrors tileset.rs:146-161 `get_image`: negative item ids
select the horizontally mirrored tile image. The augmented stack holds
[originals; mirrored copies; one black row], so flips and the
unassigned-block case (item 0 -> black, like the reference's skipped
blocks in rendering.rs:349-351) are plain row selection.

The composite is one XLA row gather plus a transpose into the band's
final row-major layout (`_compose_rows_xla`): pure data movement, which
XLA fuses on the GPU (H100 band times against a plain device copy are in
docs/KERNELS.md). Pixel data crosses the jit boundary as `[rows,
width*3]` u8 with the three channels interleaved in the minor dimension.
"""

from __future__ import annotations

import functools
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np


def _rows_of(items: jax.Array, t: int):
    """Signed items -> augmented-stack rows (tileset.rs:131-143 convention;
    rows T..2T are the pre-mirrored copies, row 2T is black for item 0)."""
    flat = items.reshape(-1)
    rows = jnp.clip(jnp.where(flat >= 0, flat - 1, t - flat - 1), 0, 2 * t - 1)
    return jnp.where(flat == 0, 2 * t, rows)


@functools.partial(jax.jit, static_argnames=("ts",))
def _compose_rows_xla(items: jax.Array, aug3: jax.Array, *, ts: int):
    """Gather + transpose. items [nby, nbx] i32, aug3 [2T+1, ts, ts*3] u8
    -> band [nby*ts, nbx*ts*3] u8."""
    nby, nbx = items.shape
    t = aug3.shape[0] // 2
    sel = aug3[_rows_of(items, t)]  # [B, ts, ts*3]
    band = sel.reshape(nby, nbx, ts, ts * 3)
    return jnp.transpose(band, (0, 2, 1, 3)).reshape(nby * ts, nbx * ts * 3)


def augment_stack2d(stack) -> tuple[jax.Array, int]:
    """[T, ts, ts, 3] uint8 -> device [2T+1, ts, ts*3] stack: originals,
    mirrored copies (the composite analogue of build_library's flip rows),
    and a black row for unassigned blocks."""
    stack = np.asarray(stack, dtype=np.uint8)
    t, ts = stack.shape[0], stack.shape[1]
    aug = np.zeros((2 * t + 1, ts, ts * 3), dtype=np.uint8)
    aug[:t] = stack.reshape(t, ts, ts * 3)
    aug[t : 2 * t] = stack[:, :, ::-1, :].reshape(t, ts, ts * 3)
    return jnp.asarray(aug), ts


def _compose_host(items_np: np.ndarray, aug3: jax.Array, ts: int) -> np.ndarray:
    """Compose one band on the device and bring it to the host as
    [nby*ts, nbx*ts, 3]."""
    nby, nbx = items_np.shape
    band = _compose_rows_xla(jnp.asarray(items_np), aug3, ts=ts)
    return np.asarray(jax.device_get(band)).reshape(nby * ts, nbx * ts, 3)


def compose_mosaic(items, stack) -> np.ndarray:
    """Assemble the mosaic image from signed tile selections.

    Args:
      items: [nby, nbx] int32 signed 1-based item ids (negative = flipped),
        the convention of tileset.rs:131-143; 0 = unassigned (black).
      stack: [T, ts, ts, 3] uint8 prepared tile images (1-based item id i
        lives at stack[i-1]).

    Returns:
      [nby*ts, nbx*ts, 3] uint8 mosaic (host numpy).
    """
    items = np.asarray(items, dtype=np.int32)
    aug3, ts = augment_stack2d(stack)
    return _compose_host(items, aug3, ts)


def iter_bands(items, stack, band_rows: int = 8) -> Iterator[np.ndarray]:
    """Stream the mosaic as horizontal bands of `band_rows` block-rows.

    For gigapixel outputs the full mosaic cannot live in HBM or host RAM;
    each yielded band is `[band_rows*ts, nbx*ts, 3]` uint8 on host, ready
    for a streaming PNG encoder (SURVEY.md section 7 "composite kernel").
    """
    items = np.asarray(items, dtype=np.int32)
    aug3, ts = augment_stack2d(stack)
    nby = items.shape[0]
    for y0 in range(0, nby, band_rows):
        yield _compose_host(items[y0 : y0 + band_rows], aug3, ts)


def iter_bands_host(
    items, tile_set, tile_size: int, band_rows: int = 4, cache_tiles: int = 4096
) -> Iterator[np.ndarray]:
    """Host-side banded composite for stacks too large for RAM/HBM
    (tile_size x library combos past ~10 GB — SURVEY §7 "memory geometry").

    Tile images stream from the prepared-tile disk cache with an LRU, the
    way the reference composes every block (tileset.rs:146-161 re-reads the
    cache per placement); flips are applied per placement. Slow relative to
    the device paths but memory-bounded: one band + the LRU.
    """
    import functools as _ft

    items = np.asarray(items, dtype=np.int32)
    nby, nbx = items.shape

    @_ft.lru_cache(maxsize=cache_tiles)
    def tile_img(idx: int) -> np.ndarray:
        from emosaic_tpu.io.prep import prepare_tile

        return prepare_tile(tile_set.get_path(idx), tile_size, crop=True)

    for y0 in range(0, nby, band_rows):
        rows = items[y0 : y0 + band_rows]
        band = np.zeros(
            (rows.shape[0] * tile_size, nbx * tile_size, 3), dtype=np.uint8
        )
        for by in range(rows.shape[0]):
            for bx in range(nbx):
                it = int(rows[by, bx])
                if it == 0:
                    continue
                img = tile_img(abs(it))
                if it < 0:
                    img = img[:, ::-1, :]
                band[
                    by * tile_size : (by + 1) * tile_size,
                    bx * tile_size : (bx + 1) * tile_size,
                ] = img
        yield band


# ---------------------------------------------------------------------------
# tint blending (reference main.rs:447-478)
# ---------------------------------------------------------------------------


def tint_scalars(alpha_255: int) -> np.ndarray:
    """The per-call f32 scalars of image-0.25.2's `Rgba::blend` (color.rs),
    computed host-side with numpy f32 (IEEE single, one rounding per op —
    the same semantics as Rust f32 expression evaluation).

    Returns [max_t, fg_a, 1-fg_a, alpha_final] as float32. With an opaque
    background (bg_a = 1.0, main.rs:464 converts RGB8 -> RGBA8) the crate's
    `alpha_final = bg_a + fg_a - bg_a*fg_a` is exactly 1.0 for 224 of the
    256 alphas and 1-2^-24 for the rest (alpha % 4 == 0, alpha >= 128) —
    the division below is therefore load-bearing and kept.
    """
    mt = np.float32(255.0)
    one = np.float32(1.0)
    fg_a = np.float32(np.float32(alpha_255) / mt)
    af = np.float32(np.float32(one + fg_a) - np.float32(one * fg_a))
    return np.array([mt, fg_a, np.float32(one - fg_a), af], np.float32)


def ref_tint_blend_u8(bg_u8, fg_u8, alpha_255: int) -> np.ndarray:
    """Scalar port of the reference tint compositing, bit-exact oracle.

    main.rs:447-478: overlay alpha = (255*opacity) as u8 (truncating),
    then imageops::overlay -> Rgba::blend per pixel (image-0.25.2
    src/color.rs `impl Blend for Rgba`): normalize to f32, src-over
    compositing with premultiplied channels, unmultiply by alpha_final,
    then `NumCast::from(255*out)` which TRUNCATES (num-traits float->u8
    goes through trunc + range check + `as` cast). Background is opaque.

    Every numpy op below rounds to f32 exactly once, in the crate's
    evaluation order; the device kernel `_tint_blend_2d` is CI-verified
    bit-equal to this for all 256 alphas x 65536 channel pairs
    (tests/test_ops.py).
    """
    mt, fg_a, inv, af = tint_scalars(alpha_255)
    one = np.float32(1.0)
    bg_r = np.float32(np.asarray(bg_u8, np.uint8).astype(np.float32) / mt)
    fg_r = np.float32(np.asarray(fg_u8, np.uint8).astype(np.float32) / mt)
    t = np.float32(
        np.float32(fg_r * fg_a) + np.float32(np.float32(bg_r * one) * inv)
    )
    u = np.float32(t / af)
    return np.trunc(np.float32(mt * u)).astype(np.uint8)


def _u8_over_255_f32(x_u8):
    """fl32(x / 255) for u8 x, computed WITHOUT a division.

    A device's f32 division need not be correctly rounded (reciprocal
    plus refinement on some accelerators, and XLA rewrites division by a
    constant into a reciprocal multiply on every backend) — so the
    quotient is built from exact operations only:
    x/255 = p / (2^32 - 1) with p = x * 16843009 (exact: 255 * 16843009
    = 2^32 - 1). The u32->f32 convert rounds p to 24 bits (RNE); the
    true quotient exceeds p * 2^-32 by p * 2^-64 + ..., which matters
    exactly at conversion *ties* — adding 1 to p breaks those upward
    (host-enumerated: changes no non-tie case; x = 0 must stay 0 and
    x = 255 would overflow, both excluded from the nudge). The 2^-32
    scale is a pure exponent shift (exact). Verified against
    fl32(x/255.0) for all 256 values (tests + on-chip check).
    """
    p = x_u8.astype(jnp.uint32) * jnp.uint32(16843009)
    nudge = ((x_u8 > 0) & (x_u8 < 255)).astype(jnp.uint32)
    return (p + nudge).astype(jnp.float32) * jnp.float32(2.0**-32)


def _tint_sample_indices(bh, ow, sh, sw, out_h, y0):
    """Host-side nearest-neighbor sample grid at output-pixel centers,
    like image::imageops::resize(FilterType::Nearest) (main.rs:456-461).
    Passed to the jit as operands so a streamed render's per-band y0
    does not trigger a recompile per band (the kernel compiles once per
    band *shape*).

    Arithmetic is deliberately FLOAT32, op for op what the kernel used
    to compute on-device ((i32->f32 index + 0.5f) * f32(ratio), truncate)
    — host f64 would pick different source rows near rounding boundaries
    for ~half of (sh, out_h) pairs, silently changing tinted pixels vs
    prior releases and the reference's own f32 resize arithmetic."""
    yr = np.float32(sh / out_h)
    yi = np.clip(
        (
            (np.arange(y0, y0 + bh, dtype=np.int32).astype(np.float32)
             + np.float32(0.5))
            * yr
        ).astype(np.int32),
        0,
        sh - 1,
    )
    xr = np.float32(sw / ow)
    xi = np.clip(
        (
            (np.arange(ow, dtype=np.int32).astype(np.float32)
             + np.float32(0.5))
            * xr
        ).astype(np.int32),
        0,
        sw - 1,
    )
    xi3 = (xi[:, None] * 3 + np.arange(3)[None, :]).reshape(-1)
    return yi.astype(np.int32), xi3.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("bump",))
def _tint_blend_2d(band2d, src2d, scal, yi, xi3, *, bump: bool):
    """band2d [bh, ow*3] u8, src2d [sh, sw*3] u8 -> blended [bh, ow*3] u8.

    (yi, xi3) are the host-computed nearest-sample indices
    (`_tint_sample_indices`), then the `Rgba::blend` arithmetic of
    `ref_tint_blend_u8` runs bit-exact on every backend. Three
    compiler/hardware hazards are designed out (each one was CAUGHT
    producing off-by-one pixels by the exhaustive oracle check):
    - x/255 via compile-time constant: XLA strength-reduces to
      x * (1/255.0). x/255 via runtime operand: exact on CPU but not
      guaranteed correctly rounded on accelerators. -> no division; see
      `_u8_over_255_f32` and the `bump` tail below.
    - mul feeding add: codegen contracts to FMA, skipping the product's
      rounding. -> products pass through abs(-x) (bit-identity for these
      non-negative values) + an optimization barrier.
    - the crate's alpha_final is 1 - 2^-24 (not 1.0) for 32 alphas; the
      division by it equals a one-ulp bit-increment for every reachable
      sum t (host-enumerated identity over all 65536 pairs per alpha) —
      `bump` selects that integer-exact tail, so alpha_final never
      reaches the device.
    """
    up = src2d[yi][:, xi3]
    mt, fg_a, inv = scal[0], scal[1], scal[2]
    fg_r = _u8_over_255_f32(up)
    bg_r = _u8_over_255_f32(band2d)
    prod_fg = jnp.abs(-(fg_r * fg_a))
    prod_bg = jnp.abs(-((bg_r * jnp.float32(1.0)) * inv))
    prod_fg, prod_bg = jax.lax.optimization_barrier((prod_fg, prod_bg))
    t = prod_fg + prod_bg
    if bump:
        t_bits = jax.lax.bitcast_convert_type(t, jnp.uint32)
        t_up = jax.lax.bitcast_convert_type(
            t_bits + jnp.uint32(1), jnp.float32
        )
        t = jnp.where(t == 0, t, t_up)
    return jnp.clip(jnp.trunc(mt * t), 0, 255).astype(jnp.uint8)


def tint_blend_band(band, src, y0: int, out_h: int, tint_opacity: float):
    """Per-band tint blend for the streamed gigapixel path: identical math
    to `tint_blend` applied to output rows [y0, y0+h)."""
    alpha = int(255.0 * float(tint_opacity))
    band = np.asarray(band, dtype=np.uint8)
    if alpha <= 0:
        # pure optimization: the blend with fg_a = 0 is the identity
        # (CI-verified bit-equal for all 65536 channel pairs at alpha 0)
        return band
    bh, ow = band.shape[0], band.shape[1]
    src = np.asarray(src, dtype=np.uint8)
    scal = tint_scalars(alpha)
    yi, xi3 = _tint_sample_indices(
        bh, ow, src.shape[0], src.shape[1], out_h, y0
    )
    out = _tint_blend_2d(
        jnp.asarray(band.reshape(bh, ow * 3)),
        jnp.asarray(src.reshape(src.shape[0], -1)),
        jnp.asarray(scal),
        jnp.asarray(yi),
        jnp.asarray(xi3),
        bump=bool(scal[3] != np.float32(1.0)),
    )
    return np.asarray(jax.device_get(out)).reshape(bh, ow, 3)


def stream_tinted_bands(
    items,
    tile_set,
    stack,
    tile_size: int,
    *,
    original_rgb=None,
    tint_opacity: float = 0.0,
    band_budget: int = 256 << 20,
):
    """Compose the mosaic as bands — device path when `stack` is given,
    host-LRU path otherwise — tint-blending each band when requested.
    Yields [h, W, 3] u8 bands top to bottom.

    The single source of truth for the gigapixel streaming pipeline:
    the CLI's banded PNG path and serve's chunked responses both use it
    (they are contract-bound to be pixel-identical).
    """
    items = np.asarray(items, dtype=np.int32)
    nby, nbx = items.shape
    out_h = nby * tile_size
    band_rows = max(1, band_budget // (nbx * tile_size**2 * 3))
    if stack is None:
        bands = iter_bands_host(items, tile_set, tile_size, band_rows=band_rows)
    else:
        bands = iter_bands(items, stack, band_rows=band_rows)
    tinting = original_rgb is not None and tint_opacity > 0.0
    y0 = 0
    for band in bands:
        if tinting:
            band = tint_blend_band(band, original_rgb, y0, out_h, tint_opacity)
        y0 += band.shape[0]
        yield band


def tint_blend(mosaic, src, tint_opacity: float) -> np.ndarray:
    """Alpha-composite the source image over the mosaic.

    Mirrors main.rs:447-465: overlay alpha is floor(255 * tint_opacity)
    (the reference's `as u8` cast truncates), source is nearest-upscaled to
    the output size, then `Rgba::blend` src-over compositing over an opaque
    background — bit-exact vs `ref_tint_blend_u8` (the scalar port of the
    image-0.25.2 float path, truncating final cast), CI-verified for all
    256 alphas x 65536 channel pairs.
    """
    mosaic = np.asarray(mosaic, dtype=np.uint8)
    return tint_blend_band(mosaic, src, 0, mosaic.shape[0], tint_opacity)
