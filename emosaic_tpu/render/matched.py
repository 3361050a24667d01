"""Matched renderer (reference: rendering.rs:124-230 `render_nto1`).

Pipeline: source -> flattened block vectors (device) -> fused L1 argmin
(LUT / Pallas / XLA) or top-k + randomized choice -> signed item grid ->
device gather composite.

Parity notes:
- stats record *source-pixel* coordinates (rendering.rs:211-214) — quirk
  preserved (the no-repeat global renderer records output coords).
- `--randomize f`: 20 nearest, keep the ascending prefix with
  `dist - min < f% * min`, choose uniformly (rendering.rs:168-185).
  Deviation (recorded): when min == 0 the reference's take_while yields an
  empty list and panics on `.choose().unwrap()`; here the best match is
  always eligible. Randomness uses an explicit seed, not thread_rng.
- `--no-repeat` with `--greedy` removes only the chosen orientation, in
  render order (rendering.rs:163-167, :207-209). The reference's order is
  scheduler-dependent (rayon rows x shuffled columns, serialized by a write
  lock); here it is deterministic: row-major rows, seeded shuffle within
  each row (mirroring the per-row shuffle at rendering.rs:73-74).
- `--no-repeat --randomize` deadlocks the reference (read-lock under write
  lock, rendering.rs:163-174); here it raises ValueError.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass

import numpy as np

from emosaic_tpu.ops.analysis import source_blocks
from emosaic_tpu.ops.composite import compose_mosaic
from emosaic_tpu.ops.distance import (
    build_library,
    l1_argmin,
    l1_argmin_hybrid,
    l1_topk,
    l2_argmin,
    rows_to_items,
)
from emosaic_tpu.ops.lut import MAX_ROWS, build_l1_lut, lut_match
from emosaic_tpu.render.greedy import greedy_sequence_assign, make_numpy_refill
from emosaic_tpu.stats import RenderStats
from emosaic_tpu.tiles.tileset import TileSet

_DEFAULT_RANDOM_NEIGHBORS = 20  # RenderConfig (rendering.rs:29-36)
_GREEDY_TOPK = 64
_LUT_MIN_BLOCKS = 4096  # below this, brute force beats LUT build cost


@dataclass
class RenderOutcome:
    """Reference RenderResult (rendering.rs:236-243)."""

    image: np.ndarray | None
    stats: RenderStats
    tile_set: TileSet
    items: np.ndarray | None = None  # [vtiles, htiles] signed item grid


def insufficient_tiles_check(n_blocks: int, n_tiles: int) -> None:
    """rendering.rs:150-156 / :288-294."""
    if n_blocks > n_tiles * 2:
        raise ValueError(
            f"❌ Insufficient tiles for no-repeat mode: need {n_blocks} tiles "
            f"but only have {n_tiles * 2} available"
        )


def start_render(source_img, tile_set, tile_size, log, *, check_tiles):
    """Shared render prologue (both renderers; keeps the grid math and
    the 'Doing WxH tiles...' line — which tests and the e2e matrix
    compare — in one place). Returns (dim, htiles, vtiles, blocks, lib).
    """
    dim = math.isqrt(tile_set.n_cells)
    h, w = source_img.shape[0], source_img.shape[1]
    htiles, vtiles = w // dim, h // dim
    log(
        f"Doing {htiles}x{vtiles} tiles resulting in a "
        f"{htiles * tile_size}x{vtiles * tile_size} image (step: {dim})"
    )
    if check_tiles:
        insufficient_tiles_check(htiles * vtiles, len(tile_set))
    blocks = np.asarray(source_blocks(source_img, dim))  # [B, 3N], y-major
    lib = np.asarray(build_library(tile_set.palettes))  # [2T, 3N]
    return dim, htiles, vtiles, blocks, lib


def finish_render(
    rows, dists, vtiles, htiles, tile_set, stats_step, tile_size, *,
    stack, compose, timed_log=None,
) -> RenderOutcome:
    """Shared render epilogue: items grid (unassigned -> black), stats,
    optional composite. `stats_step` carries the reference's coordinate
    quirk — SOURCE-pixel coords (dim) for matched modes
    (rendering.rs:211-214), OUTPUT-pixel coords (tile_size) for global
    no-repeat (rendering.rs:357-364). `timed_log` adds the no-repeat
    path's compose timing line."""
    num_tiles = len(tile_set)
    items = np.asarray(rows_to_items(rows, num_tiles))
    items = np.where(rows < 0, 0, items)  # unassigned -> black
    items_grid = items.reshape(vtiles, htiles)
    stats = RenderStats.from_grid(
        items_grid,
        np.asarray(dists).reshape(vtiles, htiles),
        stats_step,
        stats_step,
        tile_set,
    )
    image = None
    if compose:
        t0 = time.perf_counter()
        if stack is None:
            stack = tile_set.image_stack(tile_size)
        image = np.asarray(compose_mosaic(items_grid, stack))
        if timed_log is not None:
            timed_log(f"   compose: {time.perf_counter() - t0:.2f}s")
    return RenderOutcome(
        image=image, stats=stats, tile_set=tile_set, items=items_grid
    )


def match_blocks(
    blocks: np.ndarray,
    lib: np.ndarray,
    *,
    use_lut: str = "auto",
    metric: str = "l1",
    hybrid: bool = False,
    mesh=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch to the LUT (mode 1), the dense L1 argmin, the hybrid
    (L2 prefilter + exact-L1 rescore, `hybrid=True`), or the L2 fast mode
    (performance additions — the reference is L1-only). The dense
    argmin's route is the device's (ops/backend.py).

    With `mesh` (a ("data", "model") jax Mesh), the exact-L1 match shards
    blocks over "data" and the library over "model" with an all-gather
    (min, row) combine — bit-identical to the single-device kernels
    (tests/test_sharding.py). The l2/hybrid fast modes and an explicit
    `use_lut="always"` stay single-device (documented in --mesh help).

    Returns (dist [B] int32, row [B] int32) as numpy.
    """
    if metric == "l2":
        dist, row = l2_argmin(blocks, lib)
        return np.asarray(dist), np.asarray(row)
    if hybrid and blocks.shape[1] > 3:
        dist, row = l1_argmin_hybrid(blocks, lib)
        return np.asarray(dist), np.asarray(row)
    b, d = blocks.shape
    lut_ok = d == 3 and lib.shape[0] <= MAX_ROWS
    lut_auto = use_lut == "auto" and lut_ok and b >= _LUT_MIN_BLOCKS
    if mesh is not None and use_lut != "always" and not lut_auto:
        # mode-1 runs keep the packed-LUT fast path even under --mesh
        # (results are bit-identical either way; the LUT is faster)
        from emosaic_tpu.parallel import sharded_l1_argmin

        dist, row = sharded_l1_argmin(blocks, lib, mesh)
        return np.asarray(dist), np.asarray(row)
    if use_lut == "always" or lut_auto:
        if not lut_ok:
            raise ValueError("LUT path requires mode 1 and a small-enough library")
        lut = build_l1_lut(lib)
        dist, row = lut_match(blocks, lut)
        return np.asarray(dist), np.asarray(row)
    # Dedup identical query blocks before the dense kernel (the reference
    # re-searches the kd-tree per block; sources repeat colors heavily).
    # Sample first: np.unique over 16M rows isn't free.
    if b > 8192:
        sample = blocks[:: max(1, b // 4096)]
        est = len(np.unique(sample, axis=0)) / len(sample)
        if est < 0.5:
            uniq, inverse = np.unique(blocks, axis=0, return_inverse=True)
            du, ru = l1_argmin(uniq, lib)
            return np.asarray(du)[inverse], np.asarray(ru)[inverse]
    dist, row = l1_argmin(blocks, lib)
    return np.asarray(dist), np.asarray(row)


def render_nto1(
    source_img: np.ndarray,
    tile_set: TileSet,
    tile_size: int,
    no_repeat: bool = False,
    randomize: float | None = None,
    *,
    seed: int = 0,
    use_lut: str = "auto",
    metric: str = "l1",
    hybrid: bool = False,
    stack: np.ndarray | None = None,
    compose: bool = True,
    mesh=None,
    log=lambda *a: print(*a, file=sys.stderr),
) -> RenderOutcome:
    if no_repeat and randomize is not None:
        raise ValueError(
            "no_repeat + randomize is unsupported (the reference deadlocks "
            "on this combination, rendering.rs:163-174)"
        )
    if len(tile_set) == 0:
        # the reference panics deep in the kd-tree here; fail clearly
        raise ValueError("❌ No tiles available for matching")
    dim, htiles, vtiles, blocks, lib = start_render(
        source_img, tile_set, tile_size, log, check_tiles=no_repeat
    )
    if no_repeat or randomize is not None:
        # these branches always score with the exact L1 top-k: the
        # match-path-only knobs would otherwise be dropped silently
        ignored = [
            name
            for name, off in (
                (f"--matcher {use_lut}", use_lut == "auto"),
                (f"--metric {metric}", metric == "l1"),
                ("--matcher hybrid", not hybrid),
            )
            if not off
        ]
        if ignored:
            log(
                f"⚠️  {', '.join(ignored)} ignored: "
                f"{'randomize' if randomize is not None else 'greedy no-repeat'} "
                "always scores with the exact L1 top-k"
            )

    rng = np.random.default_rng(seed)

    def topk(k: int) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k candidate lists; sharded over the mesh when given
        (bit-identical contract, tests/test_sharding.py)."""
        if mesh is not None:
            from emosaic_tpu.parallel import sharded_l1_topk

            return sharded_l1_topk(blocks, lib, k, mesh)
        cd, cr = l1_topk(blocks, lib, k)
        return np.asarray(cd), np.asarray(cr)

    if randomize is not None:
        k = min(_DEFAULT_RANDOM_NEIGHBORS, lib.shape[0])
        cd, cr = topk(k)
        mins = cd[:, 0].astype(np.float64)
        eligible = (cd.astype(np.float64) - mins[:, None]) < (
            float(randomize) * mins[:, None] / 100.0
        )
        eligible[:, 0] = True  # deviation: avoid the reference's min==0 panic
        counts = eligible.sum(axis=1)
        pick = (rng.random(len(blocks)) * counts).astype(np.int64)
        rows = np.take_along_axis(cr, pick[:, None], axis=1)[:, 0]
        dists = np.take_along_axis(cd, pick[:, None], axis=1)[:, 0]
    elif no_repeat:
        k = min(_GREEDY_TOPK, lib.shape[0])
        cd, cr = topk(k)
        # render order: rows in sequence, x shuffled per row
        order = np.concatenate(
            [by * htiles + rng.permutation(htiles) for by in range(vtiles)]
        )
        from emosaic_tpu import native

        if native.available():
            rows, dists = native.greedy_sequence(order, cd, cr, blocks, lib)
        else:
            refill = make_numpy_refill(blocks, lib)
            rows, dists = greedy_sequence_assign(
                order, cd, cr, lib.shape[0], refill
            )
    else:
        dists, rows = match_blocks(
            blocks, lib, use_lut=use_lut, metric=metric, hybrid=hybrid,
            mesh=mesh,
        )

    # stats_step=dim: source-pixel coords (rendering.rs:211-214)
    return finish_render(
        rows, dists, vtiles, htiles, tile_set, dim, tile_size,
        stack=stack, compose=compose,
    )
