"""Long-lived mosaic service: `python -m emosaic_tpu.serve`.

The reference is a one-shot CLI (main.rs:346): every run re-reads the
analysis cache, rebuilds the tile stack, and — on an accelerator — pays
XLA compilation and library upload again. For production serving those
costs dominate small requests, so this module keeps a process resident
with the tile library analysed, the prepared-tile stack in memory, and
all jitted kernels warm; each request then costs only its own match +
composite + PNG encode.

HTTP surface (stdlib ThreadingHTTPServer; DEVICE work serializes on a
render lock — device work is sequential anyway — while /healthz and
request parsing stay responsive; at most `--max-pending` request bodies
are buffered at once, excess POSTs getting 503 without their bodies
read. Socket writes happen outside the lock: buffered responses
PNG-encode after release, streamed responses drain a bounded spool
(`--stream-spool-bytes` / `--spool-stall-secs`) filled by a producer
thread, so one slow client never paces the device for everyone):

    GET  /healthz            -> JSON {status, tiles, mode, tile_size}
    POST /mosaic?{params}    -> image/png
         body: the source image bytes (any PIL-decodable format)
         params: no_repeat=0|1, greedy=0|1, randomize=FLOAT (percent),
                 seed=INT, tint=FLOAT (0..1), downsample=INT

Hardening: `--warmup WxH` pre-jits the expected request shape at startup
(first-request compile cost moves to startup); bodies beyond
`--max-request-bytes` get 413 before the body is read; outputs beyond
`--stream-threshold` bytes are returned as HTTP/1.1 chunked PNG streams
encoded band-by-band (peak host memory stays one band, gigapixel-safe).

Request semantics match the CLI exactly (same renderers, same quirks —
the tint path composites over the *pre-downsample* source like
main.rs:450). Errors return JSON with a 4xx/5xx status.
"""

from __future__ import annotations

import collections
import io
import json
import os
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
from PIL import Image

from emosaic_tpu.modes import Mode
from emosaic_tpu.ops.composite import tint_blend
from emosaic_tpu.render import render_nto1, render_nto1_no_repeat
from emosaic_tpu.tiles.builder import load_or_generate_tile_set


class MosaicService:
    """Resident pipeline state: tileset + stack loaded once, kernels
    warm after the first request per shape."""

    def __init__(
        self,
        tiles_dir: str | Path,
        mode: str = "1",
        tile_size: int = 16,
        *,
        crop: bool = False,
        extensions: set[str] | None = None,
        force: bool = False,
        max_stack_bytes: int | None = None,
        log=lambda *a: print(*a, file=sys.stderr),
    ):
        from emosaic_tpu.cli import get_image_stack

        self.mode = Mode(mode)
        if self.mode is Mode.RANDOM:
            raise ValueError("serve supports matched modes (1..128), not random")
        self.dim = self.mode.dim
        self.tile_size = tile_size
        if tile_size % self.dim:
            raise ValueError(
                f"tile size {tile_size} not divisible by mode dim {self.dim}"
            )
        self.tiles_dir = Path(tiles_dir)
        self.log = log
        self.tile_set = load_or_generate_tile_set(
            self.tiles_dir,
            tile_size,
            extensions or {"jpg", "jpeg"},
            crop,
            self.dim,
            force=force,
            log=log,
        )
        if len(self.tile_set) == 0:
            raise ValueError(f"no usable tiles under {self.tiles_dir}")
        self.stack = get_image_stack(
            self.tile_set, self.tiles_dir, tile_size, max_bytes=max_stack_bytes
        )
        log(
            f"service ready: {len(self.tile_set)} tiles, mode {mode}, "
            f"tile size {tile_size}"
        )

    def render_plan(
        self,
        source_bytes: bytes,
        *,
        no_repeat: bool = False,
        greedy: bool = False,
        randomize: float | None = None,
        seed: int = 0,
        tint: float = 0.0,
        downsample: int = 1,
        stream_threshold: int = 1 << 30,
        encode: bool = True,
    ):
        """Source image bytes -> ("buffer", png_bytes) for small outputs,
        or ("stream", out_w, out_h, band_iter) for outputs larger than
        `stream_threshold` bytes (band_iter yields tinted [h, W, 3] u8
        bands top-to-bottom; the caller PNG-encodes them incrementally —
        a gigapixel response never materializes in host RAM). CLI
        semantics throughout (same renderers, same quirks).

        `encode=False` returns ("image", tinted u8 ndarray) instead of
        ("buffer", png_bytes): all DEVICE work (match, composite, tint)
        is done, but the host-side PNG encode is left to the caller — the
        serve handler encodes outside the render lock so a large buffered
        encode never stalls the device pipeline."""
        from emosaic_tpu.cli import preprocess_source

        original = Image.open(io.BytesIO(source_bytes))
        src = preprocess_source(original, max(1, downsample), self.dim)
        if src.shape[0] < self.dim or src.shape[1] < self.dim:
            raise ValueError("source too small for this mode after rounding")
        vtiles = src.shape[0] // self.dim
        htiles = src.shape[1] // self.dim
        out_h = vtiles * self.tile_size
        out_w = htiles * self.tile_size
        streaming = out_h * out_w * 3 > stream_threshold or self.stack is None
        if no_repeat and not greedy:
            out = render_nto1_no_repeat(
                src, self.tile_set, self.tile_size, stack=self.stack,
                compose=not streaming, log=self.log,
            )
        else:
            out = render_nto1(
                src, self.tile_set, self.tile_size,
                no_repeat=no_repeat,
                randomize=randomize,
                seed=seed,
                stack=self.stack,
                compose=not streaming,
                log=self.log,
            )
        if not streaming:
            image = out.image
            if tint > 0.0:
                original_rgb = np.asarray(
                    original.convert("RGB"), dtype=np.uint8
                )
                image = tint_blend(image, original_rgb, tint)
            image = np.asarray(image, dtype=np.uint8)
            if not encode:
                return ("image", image)
            buf = io.BytesIO()
            Image.fromarray(image).save(buf, "PNG")
            return ("buffer", buf.getvalue())

        from emosaic_tpu.ops.composite import stream_tinted_bands

        original_rgb = (
            np.asarray(original.convert("RGB"), dtype=np.uint8)
            if tint > 0.0
            else None
        )
        bands = stream_tinted_bands(
            out.items,
            out.tile_set,
            self.stack,
            self.tile_size,
            original_rgb=original_rgb,
            tint_opacity=tint,
        )
        return ("stream", out_w, out_h, bands)

    def render_bytes(self, source_bytes: bytes, **opts) -> bytes:
        """Source image bytes -> mosaic PNG bytes (buffered; see
        render_plan for the streamed variant). When the tile stack is too
        big for memory the plan streams regardless — the bands are then
        PNG-encoded into a buffer here."""
        opts.pop("stream_threshold", None)
        plan = self.render_plan(source_bytes, stream_threshold=1 << 62, **opts)
        if plan[0] == "buffer":
            return plan[1]
        from emosaic_tpu.io.codecs import StreamingPNGWriter

        _, out_w, out_h, bands = plan
        buf = io.BytesIO()
        with StreamingPNGWriter(buf, out_w, out_h) as w:
            for band in bands:
                w.write_band(band)
        return buf.getvalue()

    def warmup(self, width: int, height: int, *, no_repeat: bool = False):
        """Pre-jit the kernels for a WxH request shape (VERDICT r2 #4):
        the first compile of the big kernels costs minutes on a fresh
        process; running one synthetic request at startup moves that cost
        out of the first user request."""
        import time

        y, x = np.mgrid[0:height, 0:width]
        grad = np.stack(
            [
                (x * 255 // max(1, width - 1)),
                (y * 255 // max(1, height - 1)),
                ((x + y) * 255 // max(2, width + height - 2)),
            ],
            axis=-1,
        ).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(grad).save(buf, "PNG")
        t0 = time.perf_counter()
        self.render_bytes(buf.getvalue())
        if no_repeat:
            self.render_bytes(buf.getvalue(), no_repeat=True)
        self.log(
            f"warmup {width}x{height}"
            f"{' (+no-repeat)' if no_repeat else ''}: "
            f"{time.perf_counter() - t0:.1f}s"
        )


class _Spool:
    """Bounded byte spool between the device-side PNG producer and the
    client socket.

    Streamed responses used to do their device work lazily inside the
    socket-write loop, so the render lock (i.e. the device) was paced by
    the CLIENT: one slow-but-alive reader trickling a gigapixel PNG held
    the lock for the whole drain and serialized every other render
    behind one socket. The producer thread now renders+encodes into this
    spool under the lock and the handler drains it to the socket outside
    the lock — the device moves at device speed as long as the spool has
    room (`budget` bytes, so the streamed-response memory bound stays
    explicit), and a consumer that leaves the spool full for longer than
    `stall_secs` aborts the producer instead of holding the device
    hostage (0 = wait forever).

    File-like for StreamingPNGWriter (write/flush); the producer calls
    close() or fail(), the consumer iterates get() and may cancel().
    """

    def __init__(self, budget: int, stall_secs: float):
        import threading

        self._cv = threading.Condition()
        self._chunks: collections.deque[bytes] = collections.deque()
        self._bytes = 0
        self._budget = max(1, int(budget))
        self._stall = float(stall_secs)
        self._closed = False
        self.failed = False
        self._cancelled = False

    # -- producer side (under the render lock) --
    def write(self, data) -> int:
        import time

        data = bytes(data)
        if not data:
            return 0
        with self._cv:
            deadline = (
                time.monotonic() + self._stall if self._stall > 0 else None
            )
            while self._bytes >= self._budget and not self._cancelled:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(
                        f"client stalled >{self._stall:.0f}s with a full "
                        f"{self._budget}-byte stream spool"
                    )
                self._cv.wait(left)
            if self._cancelled:
                raise BrokenPipeError("stream consumer gone")
            self._chunks.append(data)
            self._bytes += len(data)
            self._cv.notify_all()
        return len(data)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def fail(self) -> None:
        with self._cv:
            self.failed = True
            self._closed = True
            self._cv.notify_all()

    # -- consumer side (the handler thread) --
    def get(self) -> bytes | None:
        """Next chunk, or None once the spool is drained and closed."""
        with self._cv:
            while not self._chunks and not self._closed:
                self._cv.wait()
            if not self._chunks:
                return None
            data = self._chunks.popleft()
            self._bytes -= len(data)
            self._cv.notify_all()
            return data

    def cancel(self) -> None:
        """Consumer is gone: make any pending/future producer write raise
        immediately so the render lock is released."""
        with self._cv:
            self._cancelled = True
            self._cv.notify_all()


class _ChunkedWriter:
    """File-like over an HTTP/1.1 chunked response body."""

    def __init__(self, wfile):
        self._w = wfile

    def write(self, data) -> int:
        if not data:
            return 0
        self._w.write(b"%x\r\n" % len(data))
        self._w.write(bytes(data))
        self._w.write(b"\r\n")
        return len(data)

    def flush(self) -> None:
        self._w.flush()

    def finish(self) -> None:
        self._w.write(b"0\r\n\r\n")
        self._w.flush()


def _make_handler(
    service: MosaicService,
    *,
    max_request_bytes: int = 64 << 20,
    max_source_pixels: int = 1 << 30,
    stream_threshold: int = 1 << 30,
    max_pending: int = 2,
    io_timeout: float | None = 60.0,
    spool_bytes: int = 64 << 20,
    spool_stall_secs: float = 120.0,
):
    import threading

    # Device work (match + composite + tint, and for streamed responses
    # the band rendering + PNG encode) is serialized on this lock; under
    # ThreadingHTTPServer /healthz and request parsing stay responsive.
    # Socket writes happen OUTSIDE the lock: buffered responses are
    # PNG-encoded and sent after release, streamed responses go through a
    # _Spool filled by a producer thread — the device is never paced by a
    # client's read speed (up to the spool budget / stall policy).
    render_lock = threading.Lock()
    # At most max_pending bodies (each up to max_request_bytes) sit in RAM
    # at once — the single-threaded server's implicit one-body bound, kept
    # explicit under threading; excess POSTs 503 before reading the body.
    pending_slots = threading.BoundedSemaphore(max_pending)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # required for chunked responses
        # Per-socket-op deadline, applied by StreamRequestHandler.setup()
        # via connection.settimeout — covers both slow-loris body reads
        # (rfile.read below) and a dead client stalling the chunked
        # gigapixel stream writes. Without it one stalled client holds
        # render_lock (and a pending slot) forever, wedging every other
        # render (ADVICE r3, medium). A timeout raises, the stream/except
        # paths close the connection, and the lock/slot are released.
        timeout = io_timeout

        def log_message(self, fmt, *args):  # route to service log
            service.log(f"[serve] {fmt % args}")

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(
                    200,
                    {
                        "status": "ok",
                        "tiles": len(service.tile_set),
                        "mode": service.mode.value,
                        "tile_size": service.tile_size,
                    },
                )
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/mosaic":
                # the request body was never read: under HTTP/1.1
                # keep-alive the unread bytes would be parsed as the next
                # request line, poisoning the connection — close it
                self._json(404, {"error": "not found"})
                self.close_connection = True
                return
            q = {k: v[-1] for k, v in parse_qs(url.query).items()}
            try:
                n = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                # malformed header: the body (if any) is unread -> close
                self.close_connection = True
                self._json(400, {"error": "invalid Content-Length header"})
                return
            try:
                if n <= 0:
                    # possibly-chunked / absent body, also unread -> close
                    self.close_connection = True
                    raise ValueError("empty request body (expected image bytes)")
                if n > max_request_bytes:
                    # refuse before reading the body (VERDICT r2 #4)
                    self._json(
                        413,
                        {
                            "error": f"request body {n} bytes exceeds the "
                            f"{max_request_bytes}-byte limit"
                        },
                    )
                    self.close_connection = True  # unread body on the wire
                    return
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            if not pending_slots.acquire(blocking=False):
                # body unread -> close; client should retry
                self._json(503, {"error": "server busy: too many queued requests"})
                self.close_connection = True
                return
            try:
                body = self.rfile.read(n)
                self._respond(body, q)
            finally:
                pending_slots.release()

        def _respond(self, body: bytes, q: dict) -> None:
            """Device work under render_lock, socket writes outside it."""
            # decompression-bomb guard (review r4): io/prep.py disables
            # PIL's global pixel limit for CLI-owned gigapixel sources,
            # so the HTTP path must bound decoded size itself — a ~100 KB
            # crafted 60000x60000 PNG would decode to ~10 GB and OOM the
            # resident service. Image.open only parses the header here.
            try:
                with Image.open(io.BytesIO(body)) as im:
                    w, h = im.size
            except Exception:
                self._json(400, {"error": "undecodable image body"})
                return
            if w * h > max_source_pixels:
                self._json(
                    413,
                    {
                        "error": f"source {w}x{h} exceeds the "
                        f"{max_source_pixels}-pixel decode limit"
                    },
                )
                return
            try:
                with render_lock:
                    plan = service.render_plan(
                        body,
                        no_repeat=q.get("no_repeat", "0") == "1",
                        greedy=q.get("greedy", "0") == "1",
                        randomize=(
                            float(q["randomize"]) if "randomize" in q else None
                        ),
                        seed=int(q.get("seed", "0")),
                        tint=float(q.get("tint", "0")),
                        downsample=int(q.get("downsample", "1")),
                        stream_threshold=stream_threshold,
                        encode=False,
                    )
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — keep the service alive
                service.log(f"[serve] request failed: {type(e).__name__}: {e}")
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if plan[0] == "image":
                # PNG encode + send on the handler thread, lock released:
                # a buffered encode (up to stream_threshold pixel bytes)
                # never stalls the next request's device work
                buf = io.BytesIO()
                Image.fromarray(plan[1]).save(buf, "PNG")
                self._send(200, buf.getvalue(), "image/png")
                return
            # Large output: the producer thread renders bands and encodes
            # PNG into a bounded spool UNDER the lock; this thread drains
            # the spool onto the socket as HTTP/1.1 chunks OUTSIDE it.
            # Peak host memory stays one band + the spool budget.
            from emosaic_tpu.io.codecs import StreamingPNGWriter

            _, out_w, out_h, bands = plan
            spool = _Spool(spool_bytes, spool_stall_secs)

            def produce():
                try:
                    with render_lock:
                        with StreamingPNGWriter(spool, out_w, out_h) as w:
                            for band in bands:
                                w.write_band(band)
                    spool.close()
                except BaseException as e:  # noqa: BLE001 — headers already
                    # sent: the truncated chunked stream tells the client
                    service.log(
                        f"[serve] stream aborted: {type(e).__name__}: {e}"
                    )
                    spool.fail()

            producer = threading.Thread(target=produce, daemon=True)
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            sink = _ChunkedWriter(self.wfile)
            producer.start()
            try:
                while True:
                    chunk = spool.get()
                    if chunk is None:
                        break
                    sink.write(chunk)
                if spool.failed:
                    self.close_connection = True
                    return
                sink.finish()
            except Exception as e:  # noqa: BLE001 — dead/stalled socket:
                # wake the producer so it aborts and releases the lock
                service.log(
                    f"[serve] stream client lost: {type(e).__name__}: {e}"
                )
                spool.cancel()
                self.close_connection = True
            finally:
                # bound the handler's wait; the producer aborts at its
                # next spool write after cancel() regardless
                producer.join(timeout=30)

    return Handler


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="emosaic-tpu-serve",
        description="Resident mosaic service (library + kernels stay warm)",
    )
    p.add_argument("tiles_dir")
    p.add_argument("-m", "--mode", default="1")
    p.add_argument("-s", "--tile-size", type=int, default=16)
    p.add_argument("--crop", action="store_true")
    p.add_argument("--extensions", action="append", default=None)
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument(
        "--max-stack-bytes",
        type=int,
        default=None,
        help="tile-stack memory cap (default: a share of the device's "
        "memory, ops/backend.py STACK_FRACTION)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8040)
    p.add_argument(
        "--warmup",
        metavar="WxH",
        default=None,
        help="Pre-jit the kernels for this request shape at startup "
        "(e.g. 1024x768) so the first request skips the compile cost",
    )
    p.add_argument(
        "--warmup-no-repeat",
        action="store_true",
        help="Also warm the no-repeat scoring/assignment path",
    )
    p.add_argument(
        "--max-request-bytes",
        type=int,
        default=64 << 20,
        help="Largest accepted request body; beyond it the service "
        "responds 413 without reading the body",
    )
    p.add_argument(
        "--max-source-pixels",
        type=int,
        default=1 << 30,
        help="Largest accepted DECODED source size in pixels (the body "
        "byte cap cannot bound a decompression bomb); beyond it the "
        "request gets 413 after a header-only parse",
    )
    p.add_argument(
        "--stream-threshold",
        type=int,
        default=1 << 30,
        help="Output byte size above which responses are chunked PNG "
        "streams (peak host memory stays one band)",
    )
    p.add_argument(
        "--max-pending",
        type=int,
        default=2,
        help="Max request bodies buffered at once (renders are serialized; "
        "excess concurrent POSTs get 503 before their body is read)",
    )
    p.add_argument(
        "--io-timeout",
        type=float,
        default=60.0,
        help="Per-socket-operation deadline in seconds (body reads and "
        "response writes); a stalled client is disconnected instead of "
        "holding the render lock. 0 disables (not recommended)",
    )
    p.add_argument(
        "--stream-spool-bytes",
        type=int,
        default=64 << 20,
        help="Encoded-PNG spool budget per streamed response: the device "
        "renders ahead of the client by up to this many bytes, so a slow "
        "reader does not pace the render lock (peak memory per stream = "
        "one band + this budget)",
    )
    p.add_argument(
        "--spool-stall-secs",
        type=float,
        default=120.0,
        help="If a streaming client leaves the spool full for this long, "
        "the render is aborted (truncated chunked response) so the device "
        "is freed. 0 waits forever",
    )
    p.add_argument(
        "--fast-prep",
        action="store_true",
        help="DCT-scaled JPEG tile prep (~4x faster cold library builds, "
        "<=1 LSB tile difference; separate caches — see io/prep.py)",
    )
    args = p.parse_args(argv)
    prev_fast = os.environ.get("EMOSAIC_FAST_PREP")
    if args.fast_prep:
        # restored on exit so a later in-process caller runs exact
        os.environ["EMOSAIC_FAST_PREP"] = "1"
    try:
        return _serve(args, p)
    finally:
        if prev_fast is None:
            os.environ.pop("EMOSAIC_FAST_PREP", None)
        else:
            os.environ["EMOSAIC_FAST_PREP"] = prev_fast


def _serve(args, p) -> int:
    service = MosaicService(
        args.tiles_dir,
        args.mode,
        args.tile_size,
        crop=args.crop,
        extensions=set(args.extensions) if args.extensions else None,
        force=args.force,
        max_stack_bytes=args.max_stack_bytes,
    )
    if args.warmup:
        try:
            w, h = (int(v) for v in args.warmup.lower().split("x"))
        except ValueError:
            p.error("--warmup expects WxH, e.g. 1024x768")
        service.warmup(w, h, no_repeat=args.warmup_no_repeat)
    # threaded: renders serialize on the handler's render lock, but
    # /healthz and request parsing stay responsive while one is in flight
    server = ThreadingHTTPServer(
        (args.host, args.port),
        _make_handler(
            service,
            max_request_bytes=args.max_request_bytes,
            max_source_pixels=args.max_source_pixels,
            stream_threshold=args.stream_threshold,
            max_pending=args.max_pending,
            io_timeout=args.io_timeout or None,
            spool_bytes=args.stream_spool_bytes,
            spool_stall_secs=args.spool_stall_secs,
        ),
    )
    print(
        f"serving on http://{args.host}:{server.server_address[1]}",
        file=sys.stderr,
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
