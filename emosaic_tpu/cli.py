"""Two-level CLI mirroring the reference surface (src/main.rs:28-155).

Global args + `prepare` / `mosaic` subcommands:

    emosaic-tpu [-s TILE_SIZE] [-o OUTPUT] IMG [--crop] prepare
    emosaic-tpu [-s TILE_SIZE] [-o OUTPUT] IMG [--crop] mosaic TILES_DIR
        [-m MODE] [-f] [-t TINT] [--no-repeat] [--downsample N]
        [--randomize PCT] [--extensions EXT ...] [--greedy] [--html]
        [--web] [--title TITLE] [--seed N]

Behavioral parity notes (quirks preserved, SURVEY.md 'quirks ledger'):
- output is always PNG-encoded regardless of -o extension (main.rs:482-483);
- the tint path saves and returns early, skipping stats/HTML (main.rs:477);
- --greedy selects the *cheaper* in-render no-repeat algorithm; without it
  --no-repeat runs the global greedy (main.rs:663-667);
- validation messages keep the emoji phrasing (main.rs:272-345).

Additions over the reference: --seed (explicit RNG; the reference is
irreproducible thread_rng), --matcher {auto,lut,pallas,xla},
--metric {l1,l2} (matmul fast mode), --stream-threshold (gigapixel banded
PNG streaming), and --profile DIR (jax.profiler trace).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
from PIL import Image

from emosaic_tpu.io.discovery import find_images
from emosaic_tpu.io.prep import cache_dir, prepare_tile
from emosaic_tpu.modes import Mode
from emosaic_tpu.monitor import MemoryMonitor, Progress, print_runtime_stats
from emosaic_tpu.ops.composite import tint_blend
from emosaic_tpu.render import render_nto1, render_nto1_no_repeat, render_random
from emosaic_tpu.stats import MosaicConfig
from emosaic_tpu.tiles.builder import load_or_generate_tile_set
from emosaic_tpu.tiles.cache import (
    load_stack_cache,
    save_stack_cache,
    stack_cache_path,
)
from emosaic_tpu.tiles.tileset import TileSet



def log(*a):
    print(*a, file=sys.stderr)


# ---------------------------------------------------------------------------
# validation (main.rs:141-155, :272-345)
# ---------------------------------------------------------------------------


def _between_zero_and_one(s: str) -> float:
    v = float(s)
    if not 0.0 <= v <= 1.0:
        raise argparse.ArgumentTypeError("Value must be between 0 and 1")
    return v


def _percentage(s: str) -> float:
    v = float(s)
    if not 0.0 <= v <= 100.0:
        raise argparse.ArgumentTypeError("Value must be between 0 and 100")
    return v


def _positive_int(s: str) -> int:
    """clap-u16 analogue: the reference cannot even represent 0/negative
    here without panicking deep in the resize; fail at the parser."""
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError("Value must be a positive integer")
    return v


def validate_tile_size(tile_size: int) -> None:
    if tile_size <= 0:  # the reference's u32 makes negatives unrepresentable
        raise SystemExit(
            "❌ Tile size must be greater than 0\n"
            "💡 Try using a value like 16, 32, or 64"
        )
    if tile_size > 1024:
        raise SystemExit(
            "❌ Tile size is too large (maximum: 1024)\n"
            "💡 Large tile sizes require significant memory and processing time"
        )


_VALID_EXTS = ["jpg", "jpeg", "png", "bmp", "gif", "tiff", "webp"]


def validate_input_image(path: Path) -> None:
    if not path.exists():
        raise SystemExit(
            f"❌ Input image does not exist: {path}\n"
            "💡 Check the file path and ensure the file exists"
        )
    if not path.is_file():
        raise SystemExit(
            f"❌ Input path is not a file: {path}\n"
            "💡 Please provide a path to an image file, not a directory"
        )
    ext = path.suffix[1:].lower()
    if not ext:
        raise SystemExit(
            "❌ Input file has no extension\n"
            "💡 Please use an image file with a proper extension like .jpg or .png"
        )
    if ext not in _VALID_EXTS:
        raise SystemExit(
            f"❌ Unsupported image format: {path.suffix[1:]}\n"
            f"💡 Supported formats: {', '.join(_VALID_EXTS)}"
        )


def validate_tiles_directory(path: Path) -> None:
    if not path.exists():
        raise SystemExit(
            f"❌ Tiles directory does not exist: {path}\n"
            "💡 Create the directory and add image files to use as tiles"
        )
    if not path.is_dir():
        raise SystemExit(
            f"❌ Tiles path is not a directory: {path}\n"
            "💡 Please provide a path to a directory containing tile images"
        )


def validate_output_path(path: Path) -> None:
    parent = path.parent
    if parent and str(parent) != "":
        if not parent.exists():
            raise SystemExit(f"Output directory does not exist: {parent}")
        if not parent.is_dir():
            raise SystemExit(f"Output parent path is not a directory: {parent}")


# ---------------------------------------------------------------------------
# argument parsing
# ---------------------------------------------------------------------------


class _ExtendExtensions(argparse.Action):
    """clap `Vec<String>` append semantics (main.rs:100-104).

    The reference accepts one value per `--extensions` occurrence and
    accumulates across occurrences; argparse `nargs="*"` would make the
    last occurrence win. This action supports both spellings:
    `--extensions jpg png` and `--extensions jpg --extensions png`
    accumulate identically, and any occurrence replaces the default.
    """

    def __call__(self, parser, namespace, values, option_string=None):
        prior = getattr(namespace, self.dest, None)
        if prior is None or prior is self.default:
            prior = []
        setattr(namespace, self.dest, list(prior) + list(values))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="emosaic-tpu",
        description="JAX photomosaic generator (emosaic-compatible)",
    )
    p.add_argument(
        "-s",
        "--tile-size",
        type=int,
        default=16,
        help="The size of each tile in the output image",
    )
    p.add_argument(
        "-o",
        "--output-path",
        type=Path,
        default=Path("./output.jpg"),
        help="Output image path (always PNG-encoded, like the reference)",
    )
    p.add_argument("img", type=Path, help="Path to input image")
    p.add_argument(
        "--crop", action="store_true", help="Crop tiles instead of resizing"
    )
    p.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="Capture a jax.profiler trace of the run into DIR "
        "(view with TensorBoard / xprof)",
    )
    p.add_argument(
        "--fast-prep",
        action="store_true",
        help="Decode JPEG tiles at a reduced DCT scale during preparation "
        "(~4x faster cold library builds, <=1 LSB tile difference; exact "
        "and fast runs keep separate caches)",
    )
    sub = p.add_subparsers(dest="subcmd")

    sub.add_parser(
        "prepare",
        help="Convert an image into a tile (trim + resize), for testing",
    )

    m = sub.add_parser("mosaic", help="Generate a mosaic")
    m.add_argument("tiles_dir", type=Path, help="Directory containing tile images")
    m.add_argument(
        "-m",
        "--mode",
        choices=[md.value for md in Mode],
        default="1",
        help="Mosaic mode",
    )
    m.add_argument(
        "-f",
        "--force",
        action="store_true",
        help="Force re-analysis of tiles (ignore analysis cache)",
    )
    m.add_argument(
        "-t",
        "--tint-opacity",
        type=_between_zero_and_one,
        default=0.0,
        help="Opacity (0..1) of the source image overlaid on the output",
    )
    m.add_argument("--no-repeat", action="store_true", help="Avoid repeating tiles")
    m.add_argument(
        "--downsample",
        type=_positive_int,
        default=1,
        help="Downsampling factor applied to the original image",
    )
    m.add_argument(
        "--randomize",
        type=_percentage,
        default=None,
        help="Select one of the best tiles randomly (within x%% of the best)",
    )
    m.add_argument(
        "--extensions",
        # "+" not "*": clap's Vec<String> requires a value per occurrence
        # (main.rs:100-104); a bare --extensions must be rejected, not
        # silently empty the extension set (ADVICE r3)
        nargs="+",
        action=_ExtendExtensions,
        default=["jpg", "jpeg"],
        help="Extensions of image files in the tiles dir (case-sensitive); "
        "repeatable — occurrences accumulate (clap parity)",
    )
    m.add_argument(
        "--greedy",
        action="store_true",
        help="With no-repeat: faster, less accurate algorithm",
    )
    m.add_argument(
        "--html",
        action="store_true",
        help="Generate interactive HTML with tile tooltips",
    )
    m.add_argument(
        "--web",
        action="store_true",
        help="Web-compatible HTML with relative URLs for static hosting",
    )
    m.add_argument("--title", default="Mosaic Widget", help="HTML page title")
    m.add_argument("--seed", type=int, default=0, help="RNG seed (reproducible runs)")
    m.add_argument(
        "--matcher",
        choices=["auto", "lut", "pallas", "xla", "hybrid"],
        default="auto",
        help="Matching kernel selection: 'lut' forces the mode-1 lookup "
        "table, 'pallas' and 'xla' skip it, 'auto' takes it where it wins; "
        "the dense exact-L1 route is the device's measured fastest "
        "(ops/backend.py); 'hybrid' = L2 matmul prefilter + "
        "exact-L1 rescore, the approximate fast mode for high-N modes "
        "(PARITY deviation; also accelerates --no-repeat scoring)",
    )
    m.add_argument(
        "--metric",
        choices=["l1", "l2"],
        default="l1",
        help="Color distance: l1 (exact reference parity) or l2 (matmul "
        "fast mode, performance addition)",
    )
    m.add_argument(
        "--stream-threshold",
        type=int,
        default=1 << 30,
        help="Output byte size above which the mosaic is composed in bands "
        "and PNG-encoded incrementally (gigapixel path)",
    )
    m.add_argument(
        "--max-stack-bytes",
        type=int,
        default=None,
        help="Tile-stack memory cap (default: a share of the device's "
        "memory); beyond it the composite streams tiles from the disk "
        "cache (huge tile_size x library combos)",
    )
    m.add_argument(
        "--png-compress-level",
        type=int,
        choices=range(0, 10),
        metavar="0..9",
        default=1,
        help="zlib level for streamed PNG output (0 = stored, fastest)",
    )
    m.add_argument(
        "--mesh",
        default="off",
        metavar="SPEC",
        help="multi-device mesh for matching/scoring: 'off' (single "
        "device), 'auto' (all devices, data-parallel), 'N' (N devices, "
        "data-parallel) or 'DxM' (D data x M library shards). Sharded "
        "results are bit-identical to single-device. Applies to the "
        "exact-L1 matchers; lut/hybrid/l2 matchers stay single-device",
    )
    m.add_argument(
        "--stats-json",
        metavar="PATH",
        default=None,
        help="also write the run statistics as JSON (totals, top-10 used, "
        "worst-10 matches, config snapshot) for pipeline consumers",
    )
    m.add_argument(
        "--png-filter",
        choices=("none", "sub", "up"),
        default="sub",
        help="PNG scanline filter for streamed output (sub/up compress "
        "photographic mosaics ~11%% smaller than none at ~same speed)",
    )
    m.add_argument(
        "--png-workers",
        type=int,
        default=None,
        metavar="N",
        help="parallel PNG compression threads (default: min(16, cpus); "
        "output bytes are identical for any worker count)",
    )
    return p


# ---------------------------------------------------------------------------
# multi-device mesh (--mesh)
# ---------------------------------------------------------------------------


def _parse_mesh(spec: str, log):
    """Resolve a --mesh spec to a ("data", "model") Mesh, or None.

    'off' -> None; 'auto' -> all visible devices, data-parallel;
    'N' -> N devices data-parallel; 'DxM' -> D data x M library shards.
    A 1-device resolution returns None (the single-device kernels are the
    same computation without the shard_map plumbing).
    """
    spec = spec.strip().lower()
    if spec == "off":
        return None
    import jax

    from emosaic_tpu.parallel import make_mesh

    avail = len(jax.devices())
    if spec == "auto":
        data, model = avail, 1
    else:
        parts = spec.split("x")
        try:
            if len(parts) == 1:
                data, model = int(parts[0]), 1
            elif len(parts) == 2:
                data, model = int(parts[0]), int(parts[1])
            else:
                raise ValueError
        except ValueError:
            raise SystemExit(
                f"❌ Invalid --mesh '{spec}': expected off, auto, N, or DxM"
            ) from None
    n = data * model
    if n > avail:
        raise SystemExit(
            f"❌ --mesh {spec} needs {n} devices but only {avail} are visible"
        )
    if n <= 1:
        return None
    mesh = make_mesh(n, model=model)
    log(f"🕸  Matching on a {data}x{model} (data x model) device mesh")
    return mesh


# ---------------------------------------------------------------------------
# source preprocessing (main.rs:567-615)
# ---------------------------------------------------------------------------


def preprocess_source(
    original: Image.Image, downsample: int, dim: int
) -> np.ndarray:
    """Downsample, round dims to the nearest multiple of dim (up when the
    remainder exceeds dim/2 — main.rs:574-585), Lanczos resize."""
    nwidth = original.width // downsample
    nheight = original.height // downsample
    wmod = nwidth % dim
    nwidth = nwidth + (dim - wmod) if wmod > dim // 2 else nwidth - wmod
    hmod = nheight % dim
    nheight = nheight + (dim - hmod) if hmod > dim // 2 else nheight - hmod
    log(
        f"Resizing source image from {original.width}x{original.height} "
        f"to {nwidth}x{nheight}"
    )
    resized = original.resize((nwidth, nheight), Image.LANCZOS)
    return np.asarray(resized.convert("RGB"), dtype=np.uint8)


def get_image_stack(
    tile_set: TileSet,
    tiles_dir: Path,
    tile_size: int,
    max_bytes: int | None = None,
) -> np.ndarray | None:
    """Prepared-tile stack with its persistent cache.

    Returns None when the dense stack would exceed `max_bytes` (default:
    `backend.device_stack_bytes()`, a share of the device's memory; e.g.
    100k tiles at tile_size 1024 is ~300 GB) — the composite then streams
    tiles from the disk cache instead (ops.composite.iter_bands_host)."""
    if max_bytes is None:
        from emosaic_tpu.ops.backend import device_stack_bytes

        max_bytes = device_stack_bytes()
    if len(tile_set) * tile_size * tile_size * 3 > max_bytes:
        log(
            "⚠️  Tile stack too large for memory; compositing will stream "
            "tiles from the disk cache"
        )
        return None
    spath = stack_cache_path(tiles_dir, tile_size)
    cached = load_stack_cache(spath, tile_set.paths)
    if cached is not None:
        return cached
    pb = Progress(len(tile_set), "Preparing tile stack")
    stack = tile_set.image_stack(tile_size, progress=pb)
    try:
        save_stack_cache(spath, tile_set.paths, stack)
    except OSError:
        pass  # non-fatal, like the stats-image save (main.rs:498-507)
    return stack


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------


def _write_rank() -> bool:
    """Host file I/O discipline under EMOSAIC_DISTRIBUTED: one rank
    writes (the pod convention), everyone computes. Always True outside
    a multi-controller run."""
    if not os.environ.get("EMOSAIC_DISTRIBUTED"):
        return True
    from emosaic_tpu.parallel.distributed import is_rank0

    return is_rank0()


def run_prepare(args) -> None:
    tile = prepare_tile(args.img, args.tile_size, args.crop)
    if _write_rank():
        Image.fromarray(tile).save(args.output_path)


def run_mosaic(args, timer=None) -> None:
    from emosaic_tpu.monitor import PhaseTimer

    timer = timer or PhaseTimer(log)
    validate_tiles_directory(args.tiles_dir)
    mode = Mode(args.mode)
    log(f"Opening source image: {args.img}")
    try:
        original = Image.open(args.img)
    except Exception as e:  # corrupt/garbage bytes behind a valid extension
        # friendly error like the reference ("Failed to open source image",
        # main.rs:396) instead of a PIL traceback
        raise SystemExit(f"❌ Failed to open source image {args.img}: {e}")

    if mode is Mode.RANDOM:
        images = find_images(args.tiles_dir, set(args.extensions))
        # Deviation (recorded): the reference pushes every discovered path
        # without validation (main.rs:415-435) and then *panics* at render
        # time on an unreadable/undersized file (rendering.rs:430-433
        # .expect). Here unreadable tiles are skipped with a warning.
        from emosaic_tpu.errors import ImageError
        from emosaic_tpu.io.prep import prepare_tile as _prep

        from emosaic_tpu.ops.backend import device_stack_bytes

        max_stack = args.max_stack_bytes
        if max_stack is None:
            max_stack = device_stack_bytes()
        keep_stack = len(images) * args.tile_size**2 * 3 <= max_stack
        good, prepared = [], []
        for p in images:
            try:
                img = _prep(p, args.tile_size, crop=True)
                if keep_stack:
                    prepared.append(img)
                good.append(p)
            except ImageError as e:
                log(f"- skipping {e}")
        if not good:
            raise SystemExit("❌ No usable tiles found")
        tile_set = TileSet(palettes=None, paths=good)
        log(f"Tile set with {len(tile_set)} tiles")
        src = np.asarray(original.convert("RGB"), dtype=np.uint8)
        stack = np.stack(prepared) if keep_stack else None
        out_h = src.shape[0] * args.tile_size
        out_w = src.shape[1] * args.tile_size
        streaming = out_h * out_w * 3 > args.stream_threshold or stack is None
        if streaming:
            rng = np.random.default_rng(args.seed)
            items = rng.integers(
                1, len(tile_set) + 1, size=src.shape[:2], dtype=np.int32
            )
            output = None
        else:
            items = None
            output = render_random(
                src, tile_set, args.tile_size, seed=args.seed, stack=stack
            )
        stats = None
        config = None
        tile_set_out = tile_set
    else:
        dim = mode.dim
        src = preprocess_source(original, args.downsample, dim)
        if src.shape[0] % dim or src.shape[1] % dim:
            log(
                f"Invalid source dimensions ({src.shape[1]}x{src.shape[0]}): "
                f"Dimensions must be divisible by {dim}"
            )
            raise SystemExit(1)
        if args.tile_size % dim:
            log(f"Invalid tile size: Tile size must be divisible by {dim}")
            raise SystemExit(1)
        with timer.phase("tile analysis (cache/generate)"):
            tile_set = load_or_generate_tile_set(
                args.tiles_dir,
                args.tile_size,
                set(args.extensions),
                args.crop,
                dim,
                force=args.force,
                progress=Progress(0, "Analysing tiles"),
            )
        log(f"Tile set with {len(tile_set)} tiles")
        with timer.phase("tile stack (cache/prepare)"):
            stack = get_image_stack(
                tile_set, args.tiles_dir, args.tile_size,
                max_bytes=args.max_stack_bytes,
            )
        use_lut = {
            "auto": "auto",
            "lut": "always",
            "pallas": "never",
            "xla": "never",
            "hybrid": "auto",
        }[args.matcher]
        hybrid = args.matcher == "hybrid"
        mesh = _parse_mesh(args.mesh, log)
        # gigapixel outputs are composed in bands and PNG-encoded
        # incrementally instead of materializing W*H*3 bytes at once;
        # stack=None (too big for memory) always streams via the host path
        out_h = (src.shape[0] // dim) * args.tile_size
        out_w = (src.shape[1] // dim) * args.tile_size
        streaming = (
            out_h * out_w * 3 > args.stream_threshold or stack is None
        )
        with timer.phase("match + compose"):
            if args.no_repeat and not args.greedy:
                dropped = [
                    n
                    for n, off in (
                        ("--randomize", args.randomize is None),
                        (f"--metric {args.metric}", args.metric == "l1"),
                        (
                            f"--matcher {args.matcher}",
                            args.matcher in ("auto", "hybrid"),
                        ),
                    )
                    if not off
                ]
                if dropped:
                    # the reference drops these silently on this route
                    # (main.rs:663-666 passes neither randomize nor a
                    # matcher choice to render_nto1_no_repeat); warn like
                    # the greedy branch does (render/matched.py)
                    log(
                        f"⚠️  {', '.join(dropped)} ignored: global "
                        "no-repeat always scores with the exact L1 top-k"
                    )
                result = render_nto1_no_repeat(
                    src, tile_set, args.tile_size, stack=stack,
                    compose=not streaming,
                    scorer="hybrid" if hybrid else "exact",
                    mesh=mesh,
                )
            else:
                result = render_nto1(
                    src,
                    tile_set,
                    args.tile_size,
                    no_repeat=args.no_repeat,
                    randomize=args.randomize,
                    seed=args.seed,
                    use_lut=use_lut,
                    metric=args.metric,
                    hybrid=hybrid,
                    stack=stack,
                    compose=not streaming,
                    mesh=mesh,
                )
        result.stats.summarise(tile_set)
        output = result.image
        items = result.items
        stats = result.stats
        tile_set_out = result.tile_set
        config = MosaicConfig(
            tile_size=args.tile_size,
            mode=mode.label,
            no_repeat=args.no_repeat,
            greedy=args.greedy,
            crop=args.crop,
            tint_opacity=args.tint_opacity,
            downsample=args.downsample,
            randomize=args.randomize,
            tiles_dir=str(args.tiles_dir),
            title=args.title,
        )

    out_path = args.output_path
    if not _write_rank():
        # multi-controller run (EMOSAIC_DISTRIBUTED): every rank computed
        # the same SPMD result above (matching/scoring ride the global
        # mesh); host file I/O — output image, stats, HTML — belongs to
        # rank 0 alone. Composition below is rank-local, so skipping it
        # here cannot desynchronize any collective.
        log("🛰  compute done on this rank; rank 0 writes the outputs")
        return

    original_rgb = None
    if args.tint_opacity > 0.0:
        # The tint overlay is built from the *original* source at full
        # resolution (main.rs:450), not the downsampled one.
        original_rgb = np.asarray(original.convert("RGB"), dtype=np.uint8)

    if streaming:
        # gigapixel path: bands composed on device, streamed into one PNG
        from emosaic_tpu.io.codecs import StreamingPNGWriter
        from emosaic_tpu.ops.composite import stream_tinted_bands

        nby, nbx = items.shape
        out_w = nbx * args.tile_size
        out_h = nby * args.tile_size
        log(f"📝 Streaming {out_w}x{out_h} output to {out_path}")
        with timer.phase("stream compose+encode"), StreamingPNGWriter(
            out_path,
            out_w,
            out_h,
            compress_level=args.png_compress_level,
            filter_type=args.png_filter,
            workers=args.png_workers,
        ) as w:
            for band in stream_tinted_bands(
                items,
                tile_set_out,
                stack,
                args.tile_size,
                original_rgb=original_rgb,
                tint_opacity=args.tint_opacity,
            ):
                w.write_band(band)
        if args.tint_opacity > 0.0:
            return  # tint path skips stats/HTML (main.rs:477 quirk)
    elif args.tint_opacity > 0.0:
        # tint path: blend, save, early return — skips stats/HTML
        # (main.rs:447-478 quirk preserved)
        blended = np.asarray(tint_blend(output, original_rgb, args.tint_opacity))
        Image.fromarray(blended).save(out_path, format="PNG")
        return
    else:
        log("✓ Mosaic generation completed successfully")
        log(f"📝 Writing output file to {out_path}")
        Image.fromarray(output).save(out_path, format="PNG")

    have_stats = stats is not None and stats.tile_count()
    if (stats is not None and not stats.tile_count()) and (
        args.stats_json or args.html or args.web
    ):
        # zero placements (e.g. a fully-starved assignment): stats.render
        # and the HTML generator would raise; say why the artifacts are
        # skipped instead of silently dropping or crashing (review r4)
        log("⚠️  No tiles recorded in statistics; skipping stats/HTML outputs")
    if have_stats:
        stats_path = out_path.with_suffix(".stats.png")
        log(f"📊 Writing statistics visualization to {stats_path}")
        try:
            Image.fromarray(stats.render(args.tile_size)).save(
                stats_path, format="PNG"
            )
            log("📊 Statistics file saved (shows tile matching quality)")
        except OSError as e:
            log(f"⚠️  Failed to save statistics image to {stats_path}: {e}")
        if args.stats_json:
            import json

            try:
                Path(args.stats_json).write_text(
                    json.dumps(
                        stats.to_dict(tile_set_out, config), indent=1
                    )
                )
                log(f"📊 Statistics JSON saved to {args.stats_json}")
            except OSError as e:  # non-fatal, like the image save
                log(f"⚠️  Failed to save statistics JSON: {e}")

    if have_stats and (args.html or args.web):
        from emosaic_tpu.web import generate_html_with_options

        html_path = out_path.with_suffix(".html")
        log(f"📄 Generating interactive HTML at {html_path}")
        generate_html_with_options(
            stats, out_path, html_path, tile_set_out, config, web=args.web
        )
        log("📄 Interactive HTML file saved (hover over tiles for details)")

    log(f"🎉 All done! Your mosaic is ready at {out_path}")


def main(argv=None) -> int:
    from emosaic_tpu.monitor import PhaseTimer

    start = time.time()
    monitor = MemoryMonitor().start()
    timer = PhaseTimer(log)
    prev_fast = os.environ.get("EMOSAIC_FAST_PREP")
    try:
        args = build_parser().parse_args(argv)
        validate_tile_size(args.tile_size)
        validate_input_image(args.img)
        validate_output_path(args.output_path)
        if args.fast_prep:
            # env-var backed so spawn-context prep workers and every cache
            # path helper see the same mode (io/prep.py module docstring);
            # restored on exit so a later in-process main() without the
            # flag runs exact
            os.environ["EMOSAIC_FAST_PREP"] = "1"
        if os.environ.get("EMOSAIC_DISTRIBUTED"):
            # join the multi-controller runtime BEFORE the first device
            # op (pod auto-discovery, or EMOSAIC_COORDINATOR/
            # EMOSAIC_NUM_PROCESSES/EMOSAIC_PROCESS_ID off pod); the
            # sharded kernels then see the pod-wide global mesh and
            # rank 0 alone writes the output files (_write_rank)
            from emosaic_tpu.parallel.distributed import init_distributed

            init_distributed()
        cache_dir().mkdir(parents=True, exist_ok=True)

        profiling = None
        if getattr(args, "profile", None):
            import jax

            Path(args.profile).mkdir(parents=True, exist_ok=True)
            jax.profiler.start_trace(args.profile)
            profiling = args.profile
        try:
            if args.subcmd == "prepare":
                run_prepare(args)
            elif args.subcmd == "mosaic":
                run_mosaic(args, timer=timer)
            # no subcommand: validate-only, like the reference's `None => ()`
        finally:
            if profiling:
                import jax

                jax.profiler.stop_trace()
                log(f"🔬 Profiler trace written to {profiling}")
        return 0
    finally:
        if prev_fast is None:
            os.environ.pop("EMOSAIC_FAST_PREP", None)
        else:
            os.environ["EMOSAIC_FAST_PREP"] = prev_fast
        timer.report()
        print_runtime_stats(start, monitor)
        monitor.stop()


if __name__ == "__main__":
    sys.exit(main())
