"""Tile-library builder (reference: main.rs:740-826 generate_tile_set).

Walks the tiles dir, prepares every image (content-hash cache), collects
per-image errors without aborting, then analyses the *whole stack at once*
on device (`ops.analysis.analyse_batch`) instead of per-tile scalar loops.
"""

from __future__ import annotations

import contextlib
import os
import sys
from pathlib import Path

import numpy as np

from emosaic_tpu.errors import ImageError
from emosaic_tpu.io.discovery import find_images
from emosaic_tpu.io.prep import prep_worker
from emosaic_tpu.ops.analysis import analyse_batch
from emosaic_tpu.tiles.cache import (
    analysis_cache_path,
    load_tileset_cache,
    save_tileset_cache,
)
from emosaic_tpu.tiles.tileset import TileSet

# Cap device memory used per analysis batch (u8 tile pixels).
_ANALYSE_BATCH_BYTES = 256 * 2**20


def _prep_workers() -> int:
    """Worker count for CPU-bound tile prep (the reference parallelizes
    this with rayon, main.rs:760-766). Capped: prep saturates disk/JPEG
    decode well before 32 processes, and each spawn pays a fresh
    interpreter. 0/1 disables the pool (single-core hosts lose to pool
    overhead); unset/invalid values take the default."""
    raw = os.environ.get("EMOSAIC_PREP_WORKERS", "")
    try:
        n = int(raw)
    except ValueError:
        n = -1  # unset or garbage -> default (never abort the build)
    if n == 0:
        # review r4: `or` treated the documented "0 disables" as falsy
        # and silently spawned the default pool
        return 1
    return n if n > 0 else min(16, os.cpu_count() or 1)


@contextlib.contextmanager
def _prep_pool(workers: int):
    """Spawn-context process pool whose workers stay jax-free.

    Spawn workers re-import the `emosaic_tpu` package to unpickle
    `prep_worker`, and the package __init__ imports jax for the
    compilation-cache setup. Spawned children inherit the parent's
    *current* environment, so EMOSAIC_NO_COMPILE_CACHE=1 (honored by
    __init__) and JAX_PLATFORMS=cpu are set for the pool's lifetime —
    workers never import jax or touch the parent's device client; prep
    itself is PIL/numpy only."""
    import concurrent.futures
    import multiprocessing

    guard = {"EMOSAIC_NO_COMPILE_CACHE": "1", "JAX_PLATFORMS": "cpu"}
    saved = {k: os.environ.get(k) for k in guard}
    os.environ.update(guard)
    try:
        with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn"),
        ) as pool:
            yield pool
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def generate_tile_set(
    tiles_dir: str | os.PathLike,
    tile_size: int,
    extensions: set[str],
    crop: bool,
    dim: int,
    progress=None,
    log=print,
) -> tuple[TileSet, list[ImageError]]:
    """Prepare + analyse every image under `tiles_dir`.

    Returns (tile_set, errors). Errors are reported, not fatal
    (main.rs:759-806). Indices are 1-based in discovery order
    (main.rs:786-794).
    """
    tiles_dir = Path(tiles_dir)
    image_paths = find_images(tiles_dir, extensions)

    # prepare + analyse in bounded chunks: only `chunk` prepared images are
    # resident at once (a 100k-tile library at tile_size 1024 would need
    # ~300 GB if fully materialized — SURVEY §7 "memory geometry")
    chunk = max(1, _ANALYSE_BATCH_BYTES // (tile_size * tile_size * 3))
    errors: list[ImageError] = []
    paths: list[Path] = []
    dates: list[str | None] = []
    palette_parts: list[np.ndarray] = []
    pending: list[np.ndarray] = []

    def flush():
        if pending:
            palette_parts.append(np.asarray(analyse_batch(np.stack(pending), dim)))
            pending.clear()

    def consume(i, path, img, date, err):
        if err is not None:
            # error paths are reported relative to the tiles dir (main.rs:770)
            try:
                rel = Path(path).relative_to(tiles_dir)
            except ValueError:
                rel = Path(path)
            errors.append(ImageError(rel, err))
        else:
            pending.append(img)
            paths.append(Path(path))
            dates.append(date)
            if len(pending) >= chunk:
                flush()
        if progress is not None:
            progress(i + 1, len(image_paths))

    workers = _prep_workers()
    if workers <= 1:
        for i, path in enumerate(image_paths):
            p, img, date, err = prep_worker((path, tile_size, crop))
            consume(i, p, img, date, err)
    else:
        with _prep_pool(workers) as pool:
            # map preserves discovery order (1-based idx, main.rs:786-794);
            # chunksize bounds pickling overhead for large libraries
            results = pool.map(
                prep_worker,
                ((p, tile_size, crop) for p in image_paths),
                chunksize=16,
            )
            for i, (p, img, date, err) in enumerate(results):
                consume(i, p, img, date, err)
    flush()

    if not paths:
        ts = TileSet(
            palettes=np.zeros((0, dim * dim, 3), dtype=np.uint8), paths=[]
        )
        return ts, errors

    palettes = np.concatenate(palette_parts)
    ts = TileSet(palettes=palettes, paths=paths, dates=dates)
    summarise_tileset(ts, log=log)
    log(f"Extracted {sum(d is not None for d in dates)} dates successfully")
    if errors:
        log(f"Failed to read the following images({len(errors)}):")
        for e in errors:
            log(f"- {e}")
    return ts, errors


def summarise_tileset(ts: TileSet, log=print) -> None:
    """Unique-palette count (main.rs:813-826)."""
    unique = len({ts.palettes[i].tobytes() for i in range(len(ts))})
    log(f"The analysis produced {unique} unique tiles")


def load_or_generate_tile_set(
    tiles_dir: str | os.PathLike,
    tile_size: int,
    extensions: set[str],
    crop: bool,
    dim: int,
    force: bool = False,
    progress=None,
    log=lambda *a: print(*a, file=sys.stderr),
) -> TileSet:
    """Analysis-cache orchestration (main.rs:597-661): reuse the
    `.emosaic_{N}to1[_cropped]` cache unless --force; rewrite on miss."""
    cpath = analysis_cache_path(tiles_dir, dim * dim, crop)
    if not force:
        cached = load_tileset_cache(cpath, extensions)
        if cached is not None:
            log("Reusing analysis cache")
            return cached
    ts, _errors = generate_tile_set(
        tiles_dir, tile_size, extensions, crop, dim, progress=progress, log=log
    )
    save_tileset_cache(cpath, ts)
    return ts
