"""Smoke test of the photomosaic main path on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 0-4
    python chip_smoke.py --four-cards  # four cards: the --mesh path only

Drives the system through the entry points a user calls
(`emosaic_tpu.cli.main`, and `emosaic_tpu.serve`'s service behind its HTTP
handler) at the reference's flagship deployment — `-s 32 -m 32 --crop
--no-repeat --web` with a 32 767-tile library (65 534 rows with flips,
D = 3072) against a 4096^2 source — with data generated from `--seed`
(`emosaic_tpu.synth`). Phases:

0. environment: card name and power limit, versions, a clean rebuild of
   `native/` from the tracked sources, the compile-cache directory;
1. kernels: every matcher route compiled for the card at real widths and
   compared bit for bit with the plain references (the XLA scan and a
   host int64 brute force), plus the tint blend (all 256 alphas x 65 536
   pairs), the LUT build, tie order of top_k and the two-key sort, the
   coarse projection and the composite;
2. the flagship no-repeat render through the CLI, and the same render at
   mode 16 (D = 768, where no-repeat top-k takes the adaptive scorer);
3. matched renders (mode 4: the Triton kernel route; mode 1: the LUT);
4. `serve` answering three requests, each compared with the CLI's output.

Times printed per phase are smoke timings, not benchmark results. Exits
non-zero, without the final `ok` line, when there is no GPU or any check
fails. The last line of standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import http.client
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

T_TILES = 32767  # the reference's tile cap (tileset.rs:178-183)
TILE_PX = 32
SRC_BLOCKS = 128  # 4096^2 source at dim 32
B_REAL, L_REAL = 16384, 2 * T_TILES
SAMPLE = 256


class SmokeFailure(AssertionError):
    pass


def log(*a):
    print(*a, flush=True)


def check(cond, what: str):
    if not cond:
        raise SmokeFailure(what)
    log(f"  ok: {what}")


def host_l1(blocks: np.ndarray, lib: np.ndarray) -> np.ndarray:
    """[s, L] int64 exact L1 distances on the host (threads over blocks,
    chunks over library rows)."""
    lib16 = lib.astype(np.int16)

    def one(x):
        x16 = x.astype(np.int16)
        out = np.empty(lib.shape[0], np.int64)
        for lo in range(0, lib.shape[0], 8192):
            out[lo:lo + 8192] = np.abs(lib16[lo:lo + 8192] - x16).sum(
                1, dtype=np.int64
            )
        return out

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        return np.stack(list(ex.map(one, blocks)))


def host_topk(full: np.ndarray, k: int):
    """Ascending (distance, row) top-k of each row of a host matrix."""
    order = np.lexsort((np.broadcast_to(np.arange(full.shape[1]), full.shape),
                        full), axis=1)[:, :k]
    return np.take_along_axis(full, order, 1), order


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


# ---------------------------------------------------------------------------
# phase 0: environment
# ---------------------------------------------------------------------------


def phase_env(jax):
    import emosaic_tpu
    from emosaic_tpu import native

    log(f"python {sys.version.split()[0]}, jax {jax.__version__}, "
        f"devices {jax.devices()}")
    log(f"compile cache: {emosaic_tpu.compile_cache_dir()}")
    built = native._build(force=True)
    native._lib, native._load_attempted = None, False
    log(f"native: make -B from tracked sources -> "
        f"{'built' if built else 'FAILED'}; greedy engine: "
        f"{'C++ native' if native.available() else 'numpy fallback'}")


# ---------------------------------------------------------------------------
# phase 1: kernels at real widths
# ---------------------------------------------------------------------------


def phase_kernels(jax, seed: int):
    import jax.numpy as jnp

    from emosaic_tpu import synth
    from emosaic_tpu.ops import backend, composite, distance, lut

    rng = np.random.default_rng(seed)
    plat = backend.platform()
    for d in (12, 48, 192, 768, 3072):
        blocks, lib = synth.clustered_vectors(B_REAL, L_REAL, d, seed + d)
        route = backend.argmin_route(plat, d)
        t0 = time.perf_counter()
        ref = tuple(map(np.asarray, distance.l1_argmin_xla(blocks, lib)))
        t_ref = time.perf_counter() - t0
        idx = rng.choice(B_REAL, SAMPLE, replace=False)
        full = host_l1(blocks[idx], lib)
        check(np.array_equal(ref[0][idx], full.min(1))
              and np.array_equal(ref[1][idx], full.argmin(1)),
              f"D={d}: scan oracle == host int64 brute force "
              f"({SAMPLE} blocks)")
        routes = {"auto": lambda: distance.l1_argmin(blocks, lib),
                  "stripes": lambda: distance.l1_argmin_stripes(blocks, lib)}
        if d <= backend.TRITON_MAX_D:
            routes["triton"] = lambda: distance.l1_argmin_triton(blocks, lib)
        else:
            routes["adaptive entry k=1"] = lambda: tuple(
                a[:, 0] for a in distance.l1_topk_adaptive(blocks, lib, 1)
            )
        for name, fn in routes.items():
            t0 = time.perf_counter()
            got = tuple(map(np.asarray, fn()))
            dt = time.perf_counter() - t0
            check(np.array_equal(got[0], ref[0])
                  and np.array_equal(got[1], ref[1]),
                  f"D={d} route {name}"
                  f"{' (=' + route + ')' if name == 'auto' else ''} bit-equal "
                  f"to the scan on all {B_REAL} blocks "
                  f"[{dt:.2f} s incl. compile; scan {t_ref:.2f} s]")
    # forced ties: every library row present three times
    blocks, lib = synth.clustered_vectors(B_REAL, L_REAL // 3, 48, seed)
    lib3 = np.concatenate([lib, lib, lib])
    blocks = lib[rng.integers(0, lib.shape[0], B_REAL)]
    ref = tuple(map(np.asarray, distance.l1_argmin_xla(blocks, lib3)))
    for name, fn in (("triton", distance.l1_argmin_triton),
                     ("stripes", distance.l1_argmin_stripes)):
        got = tuple(map(np.asarray, fn(blocks, lib3)))
        check(np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
              and (got[0] == 0).all() and (got[1] < lib.shape[0]).all(),
              f"ties (library x3, D=48): {name} keeps the lowest row")
    # tie order of lax.top_k (stripes) and of the two-key sorts (two-level,
    # adaptive rescore), duplicated rows, against a host lexicographic top-k
    k = 16
    lib_t = np.concatenate([lib, lib[:4096]])
    bt = blocks[:4096]
    full = host_l1(bt[:SAMPLE], lib_t)
    ed, er = host_topk(full, k)
    for name, fn in (("top_k (stripes)", distance.l1_topk_stripes),
                     ("two-key sort (two-level)", distance.l1_topk_twolevel),
                     ("two-key sort (adaptive)", distance.l1_topk_adaptive)):
        od, orow = fn(bt, lib_t, k)
        check(np.array_equal(np.asarray(od)[:SAMPLE], ed)
              and np.array_equal(np.asarray(orow)[:SAMPLE], er),
              f"tie order of {name}, duplicated rows, k={k}")
    # the coarse projection is an exact group sum (bf16 0/1 matmul)
    _, libw = synth.clustered_vectors(1, L_REAL, 3072, seed)
    proj = np.asarray(jax.jit(
        lambda x: distance._ad_project(x, 3072, 32, True)
    )(jnp.asarray(libw)))
    host = libw.reshape(L_REAL, 1024 // 32, 32, 3).astype(np.int64).sum(2)
    check(np.array_equal(proj, host.reshape(L_REAL, -1)),
          "_ad_project at D=3072, g=32 equals the host group sums")
    # tint: every alpha x every (mosaic, source) channel pair
    m = np.broadcast_to(np.arange(256, dtype=np.uint8)[:, None, None],
                        (256, 256, 3))
    s = np.broadcast_to(np.arange(256, dtype=np.uint8)[None, :, None],
                        (256, 256, 3))
    bad = 0
    for alpha in range(1, 256):
        got = composite.tint_blend(m, s, (alpha + 0.5) / 255.0)
        bad += int((got != composite.ref_tint_blend_u8(m, s, alpha)).sum())
    check(bad == 0, "tint blend bit-exact for all 256 alphas x 65536 pairs "
          "(alpha 0 is the identity)")
    # LUT (mode 1) against a brute-force nearest neighbour
    pal = synth.clustered_tiles(T_TILES, 1, seed)
    lib1 = np.asarray(distance.build_library(pal.reshape(T_TILES, 1, 3)))
    q = rng.integers(0, 256, (65536, 3), dtype=np.uint8)
    d1, r1 = lut.lut_match(q, lut.build_l1_lut(lib1))
    full = host_l1(q[:4096], lib1)
    check(np.array_equal(np.asarray(d1)[:4096], full.min(1))
          and np.array_equal(np.asarray(r1)[:4096], full.argmin(1)),
          "LUT build + match equals brute force on 4096 colours")
    # composite at the flagship shape against a host composite
    tiles = synth.clustered_tiles(T_TILES, TILE_PX, seed)
    items = rng.integers(-T_TILES, T_TILES + 1,
                         (SRC_BLOCKS, SRC_BLOCKS)).astype(np.int32)
    got = composite.compose_mosaic(items, tiles)
    aug = np.concatenate([tiles, tiles[:, :, ::-1], np.zeros_like(tiles[:1])])
    sel = np.where(items > 0, items - 1, np.where(items < 0, T_TILES - items - 1,
                                                  2 * T_TILES))
    want = aug[sel].transpose(0, 2, 1, 3, 4).reshape(got.shape)
    check(np.array_equal(got, want),
          "composite equals the host composite at 4096^2, ts=32")


# ---------------------------------------------------------------------------
# data and CLI helpers
# ---------------------------------------------------------------------------


def write_library(root: Path, seed: int):
    from PIL import Image

    from emosaic_tpu import synth

    tiles = synth.clustered_tiles(T_TILES, TILE_PX, seed)
    tdir = root / "tiles"
    tdir.mkdir()

    def save(i):
        Image.fromarray(tiles[i]).save(tdir / f"t{i:05d}.jpg", quality=95)

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        list(ex.map(save, range(T_TILES)))
    return tiles, tdir


def write_source(path: Path, tiles, grid: int, seed: int):
    from PIL import Image

    from emosaic_tpu import synth

    src, _ = synth.clustered_source(tiles, grid, grid, seed)
    Image.fromarray(src).save(path, compress_level=1)
    return src


def run_cli(args):
    from emosaic_tpu import cli

    rc = cli.main([str(a) for a in args])
    if rc != 0:
        raise SmokeFailure(f"cli exited {rc}: {args}")


def read_png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class Spy:
    """Records the arguments and result of one function the CLI calls."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def wrapper(*a, **kw):
            out = self.orig(*a, **kw)
            self.calls.append((a, kw, out))
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def block_means(img: np.ndarray, step: int) -> np.ndarray:
    h, w = img.shape[0] // step, img.shape[1] // step
    return img.reshape(h, step, w, step, 3).mean((1, 3))


# ---------------------------------------------------------------------------
# phase 2: flagship no-repeat through the CLI
# ---------------------------------------------------------------------------


def flagship_args(work: Path, out: Path, mesh: str = "off"):
    return ["-s", TILE_PX, "-o", out, work / "src4096.png", "--crop", "mosaic",
            work / "tiles", "-m", "32", "--no-repeat", "--web",
            "--mesh", mesh]


def no_repeat_cli(args, rng, label: str):
    """Run a no-repeat render through the CLI; check that every block got
    a unique tile and that the scorer's top-k equals a host brute force
    on a sample. Returns whether the scorer entered the two-level one."""
    from emosaic_tpu import cli
    from emosaic_tpu.ops import distance
    from emosaic_tpu.render import norepeat

    with Spy(cli, "render_nto1_no_repeat") as r_spy, \
            Spy(norepeat, "l1_topk_adaptive") as k_spy, \
            Spy(distance, "l1_topk_twolevel") as t_spy:
        run_cli(args)
    items = r_spy.calls[0][2].items
    placed = items[items != 0]
    check(placed.size == items.size, f"{label}: all {items.size} blocks placed")
    check(np.unique(placed).size == placed.size,
          f"{label}: every placement is unique (signed tile ids)")
    (blocks, lib, k), _, (cd, cr) = k_spy.calls[0]
    idx = rng.choice(blocks.shape[0], 48, replace=False)
    ed, er = host_topk(host_l1(blocks[idx], lib), k)
    check(np.array_equal(np.asarray(cd)[idx], ed)
          and np.array_equal(np.asarray(cr)[idx], er),
          f"{label}: scorer top-{k} (D={blocks.shape[1]}) equals a host "
          "brute force on 48 blocks")
    return bool(t_spy.calls)


def phase_flagship(work: Path, rng):
    out = work / "flagship.png"
    no_repeat_cli(flagship_args(work, out), rng, "flagship")
    for suffix in (".stats.png", ".html", "_widget.html"):
        p = out.with_name(out.stem + suffix) if suffix != ".stats.png" \
            else out.with_suffix(".stats.png")
        check(p.exists() and p.stat().st_size > 0, f"{p.name} written")
    mosaic = read_png(out)
    src = read_png(work / "src4096.png")
    corr = np.corrcoef(block_means(mosaic, TILE_PX).ravel(),
                       block_means(src, TILE_PX).ravel())[0, 1]
    check(corr > 0.9, f"block-mean correlation with the source {corr:.4f} > 0.9")
    # mode 16 (16 px blocks) on a 2048^2 crop: 16 384 blocks against
    # 65 534 rows, D = 768
    args = ["-s", TILE_PX, "-o", work / "m16.png", work / "src2048.png",
            "--crop", "mosaic", work / "tiles", "-m", "16", "--no-repeat"]
    twolevel = no_repeat_cli(args, rng, "mode 16")
    check(not twolevel, "mode 16: top-k scored by the adaptive scorer "
          "(the two-level scorer never entered)")
    return mosaic


# ---------------------------------------------------------------------------
# phase 3: matched runs
# ---------------------------------------------------------------------------


def matched_args(work: Path, src: Path, out: Path, mode: str, *extra):
    return ["-s", 16, "-o", out, src, "mosaic", work / "tiles", "-m", mode,
            "--stream-threshold", 1 << 27, *extra]


def phase_matched(work: Path, rng):
    from emosaic_tpu.render import matched

    for mode, route in (("4", "Triton kernel"), ("1", "LUT")):
        out = work / f"m{mode}.png"
        with Spy(matched, "match_blocks") as spy:
            run_cli(matched_args(work, work / "src1024.png", out, mode))
        (blocks, lib), kw, (dist, row) = spy.calls[0]
        idx = rng.choice(blocks.shape[0], SAMPLE, replace=False)
        full = host_l1(blocks[idx], lib)
        check(np.array_equal(np.asarray(dist)[idx], full.min(1))
              and np.array_equal(np.asarray(row)[idx], full.argmin(1)),
              f"mode {mode} ({route}): {SAMPLE} sampled placements are exact "
              "argmins (lowest row on ties)")


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------


def phase_serve(work: Path):
    from http.server import ThreadingHTTPServer

    from emosaic_tpu import serve

    service = serve.MosaicService(work / "tiles", "4", 16, log=lambda *a: None)
    server = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        serve._make_handler(
            service, max_request_bytes=64 << 20, max_source_pixels=1 << 30,
            stream_threshold=1 << 27, max_pending=2, io_timeout=120.0,
            spool_bytes=64 << 20, spool_stall_secs=120.0,
        ),
    )
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        cases = (("src1024.png", "", []), ("src768x512.png", "", []),
                 ("src768x512.png", "tint=0.5", ["-t", "0.5"]))
        for name, query, extra in cases:
            src = work / name
            ref_out = work / f"cli_{src.stem}_{query or 'plain'}.png"
            if name == "src1024.png" and not query:
                shutil.copy(work / "m4.png", ref_out)  # phase 3's CLI output
            else:
                run_cli(matched_args(work, src, ref_out, "4", *extra))
            conn = http.client.HTTPConnection(
                "127.0.0.1", server.server_address[1], timeout=300
            )
            t0 = time.perf_counter()
            conn.request("POST", f"/mosaic?{query}", body=src.read_bytes())
            resp = conn.getresponse()
            body = resp.read()
            dt = time.perf_counter() - t0
            conn.close()
            check(resp.status == 200, f"serve {name} {query}: HTTP 200 "
                  f"[{dt:.2f} s]")
            from PIL import Image

            got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
            check(np.array_equal(got, read_png(ref_out)),
                  f"serve {name} {query or '(no tint)'} pixel-identical to "
                  "the CLI output")
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)


# ---------------------------------------------------------------------------
# --four-cards: the --mesh path against the single-device result
# ---------------------------------------------------------------------------


def phase_mesh(work: Path):
    base = read_png(work / "flagship.png")
    for mesh in ("4", "2x2"):
        out = work / f"flagship_mesh{mesh}.png"
        run_cli(flagship_args(work, out, mesh))
        check(np.array_equal(read_png(out), base),
              f"flagship no-repeat --mesh {mesh} bit-identical to one device")
    # mode 4 at the flagship's tile size and crop, so the prepared-tile
    # stack the flagship built is reused
    args = ["-s", TILE_PX, "--crop", "mosaic", work / "tiles", "-m", "4"]
    src = work / "src1024.png"
    run_cli(["-o", work / "m4.png", src] + args)
    run_cli(["-o", work / "m4_mesh4.png", src] + args + ["--mesh", "4"])
    check(np.array_equal(read_png(work / "m4_mesh4.png"),
                         read_png(work / "m4.png")),
          "mode 4 --mesh 4 bit-identical to one device")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the --mesh path on four cards")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    try:
        import emosaic_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the emosaic_tpu package is missing: {e}",
              file=sys.stderr)
        return 2
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    n_dev = len(jax.devices())
    if args.four_cards and n_dev < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found {n_dev}",
              file=sys.stderr)
        return 2
    log(f"card: {card_line()}")
    rng = np.random.default_rng(args.seed)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    os.environ["XDG_CACHE_HOME"] = str(work / "xdg")  # prepared-tile cache
    timings = {}

    def phase(name, fn, *a):
        log(f"== {name}")
        t0 = time.perf_counter()
        out = fn(*a)
        timings[name] = time.perf_counter() - t0
        log(f"   smoke timing: {name} {timings[name]:.1f} s")
        return out

    try:
        phase("0 environment", phase_env, jax)
        tiles, _ = phase("data", write_library, work, args.seed)
        src = write_source(work / "src4096.png", tiles, SRC_BLOCKS, args.seed)
        from PIL import Image

        h, w = src.shape[:2]  # 4096^2: 2048^2, 1024^2 and 768x512 crops
        Image.fromarray(src[: h // 2, : w // 2]).save(work / "src2048.png")
        Image.fromarray(src[: h // 4, : w // 4]).save(work / "src1024.png")
        Image.fromarray(
            src[h // 4 : h // 4 + h // 8, w // 2 : w // 2 + 3 * w // 16]
        ).save(work / "src768x512.png")
        if args.four_cards:
            phase("flagship, one device", run_cli,
                  flagship_args(work, work / "flagship.png"))
            phase("mesh", phase_mesh, work)
        else:
            phase("1 kernels", phase_kernels, jax, args.seed)
            phase("2 flagship no-repeat CLI", phase_flagship, work, rng)
            phase("3 matched CLI", phase_matched, work, rng)
            phase("4 serve", phase_serve, work)
    except Exception as e:  # any phase failing fails the smoke
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("smoke timings (s): " + json.dumps(
        {k: round(v, 1) for k, v in timings.items()}))
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n_dev,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
