"""ctypes bindings for the C++ runtime helpers (native/emosaic_native.cpp).

The device owns every batched kernel; the C++ side owns the inherently
sequential no-repeat assignment loops and per-image scans. All entry
points have pure-Python fallbacks (render/greedy.py, io/prep.py) used when
the shared library is absent; `load()` builds it on demand with `make`
when a toolchain is available.

The library is built with `-march=native`, so a binary is only loaded on
the machine that built it: a stamp beside it records the source hash and
the boot id of the building host, and any mismatch (a binary copied in
with the checkout, a changed source) forces a clean rebuild.
"""

from __future__ import annotations

import ctypes
import hashlib
import platform
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).parent.parent / "native"
_LIB_NAME = "libemosaic_native.so"
_STAMP_NAME = ".build_stamp"
_lib = None
_load_attempted = False

#: C signature of the batched-refill callback (emosaic_native.cpp
#: emosaic_refill_cb): (user, block_ids*, m, used*, out_d*, out_r*) -> rc
_REFILL_CFUNC = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int64,
    ctypes.POINTER(ctypes.c_uint8),
    ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.c_int32),
)


def load() -> ctypes.CDLL | None:
    """Load (building if necessary) the native library; None on failure."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    _lib = _load_inner(rebuild=False)
    return _lib


def build_key() -> str:
    """Identity of a valid build here: the tracked sources plus this boot
    of this machine."""
    h = hashlib.sha1()
    for name in ("emosaic_native.cpp", "Makefile"):
        p = _NATIVE_DIR / name
        h.update(p.read_bytes() if p.exists() else b"")
    try:
        h.update(Path("/proc/sys/kernel/random/boot_id").read_bytes())
    except OSError:
        h.update(platform.node().encode())
    return h.hexdigest()


def _built_here() -> bool:
    stamp = _NATIVE_DIR / _STAMP_NAME
    try:
        return stamp.read_text().strip() == build_key()
    except OSError:
        return False


def _build(force: bool) -> bool:
    try:
        # serialize the on-demand build: parallel prep workers may all
        # hit a missing .so at once, and concurrent `make` runs would
        # race on the output file
        import fcntl

        with open(_NATIVE_DIR / ".build.lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if force:
                # unlink first: a truncate-in-place rebuild keeps the
                # inode, and dlopen caches by (dev, inode) — re-CDLL
                # would return the already-loaded stale handle
                (_NATIVE_DIR / _LIB_NAME).unlink(missing_ok=True)
            # -B on force: unlinking the .so alone is not enough — if a
            # stale object file's mtime is newer than its changed source
            # (checkout, clock skew), plain make relinks the same stale
            # objects and the AttributeError recurs, silently degrading
            # to the Python fallbacks (ADVICE r3)
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)] + (["-B"] if force else []),
                check=True,
                capture_output=True,
                timeout=120,
            )
            (_NATIVE_DIR / _STAMP_NAME).write_text(build_key())
        return True
    except Exception:
        return False


def _load_inner(rebuild: bool) -> ctypes.CDLL | None:
    path = _NATIVE_DIR / _LIB_NAME
    if not rebuild and path.exists() and not _built_here():
        # built on another machine or from other sources: never load it
        rebuild = True
    if rebuild or not path.exists():
        # rebuild=True forces `make -B`: a stale .so from an older source
        # tree may load but miss newly added symbols
        if not _build(force=rebuild) or not path.exists():
            return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:  # missing file / bad ELF
        return None if rebuild else _load_inner(rebuild=True)
    try:
        return _bind(lib)
    except AttributeError:
        # missing symbol: a stale build from an older source tree. Close
        # the handle — glibc's dlopen caches by pathname, so without the
        # dlclose the post-rebuild CDLL would return this same stale
        # mapping — then force one rebuild; give up -> Python fallbacks.
        try:
            import _ctypes

            _ctypes.dlclose(lib._handle)
        except Exception:
            pass
        return None if rebuild else _load_inner(rebuild=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64

    lib.emosaic_greedy_sequence.argtypes = [
        i32p, i32p, i32p, i64, i64, u8p, u8p, i64, i64, i32p, i32p
    ]
    lib.emosaic_greedy_sequence.restype = ctypes.c_int
    lib.emosaic_greedy_global.argtypes = [
        i32p, i32p, i64, i64, u8p, u8p, i64, i64, i64, i32p, i32p
    ]
    lib.emosaic_greedy_global.restype = ctypes.c_int
    lib.emosaic_greedy_global_cb.argtypes = [
        i32p, i32p, i64, i64, u8p, u8p, i64, i64, i64,
        _REFILL_CFUNC, ctypes.c_void_p, i64, i64, i64, i32p, i32p
    ]
    lib.emosaic_greedy_global_cb.restype = ctypes.c_int
    lib.emosaic_trim_bounds.argtypes = [u8p, i64, i64, i32p]
    lib.emosaic_trim_bounds.restype = None
    return lib


def available() -> bool:
    return load() is not None


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype=dtype)


def greedy_sequence(order, cand_d, cand_r, blocks, lib) -> tuple[np.ndarray, np.ndarray]:
    """Native in-render no-repeat assignment (see render/greedy.py)."""
    nl = load()
    b, k = cand_d.shape
    order = _c(order, np.int32)
    cand_d = _c(cand_d, np.int32)
    cand_r = _c(cand_r, np.int32)
    blocks = _c(blocks, np.uint8)
    lib = _c(lib, np.uint8)
    out_row = np.empty(b, dtype=np.int32)
    out_dist = np.empty(b, dtype=np.int32)
    rc = nl.emosaic_greedy_sequence(
        order, cand_d, cand_r, b, k, blocks, lib,
        lib.shape[0], lib.shape[1], out_row, out_dist,
    )
    if rc != 0:
        raise RuntimeError(f"emosaic_greedy_sequence rc={rc}")
    return out_row, out_dist


def greedy_global(
    cand_d,
    cand_r,
    blocks,
    lib,
    num_tiles,
    *,
    refill_cb=None,
    cb_k: int | None = None,
    cb_margin: int = 8,
    cb_max_batch: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """Native global-greedy no-repeat assignment (see render/greedy.py).

    `refill_cb`, when given, replaces the engine's per-block host refill
    scans with batched device top-k calls — a Python callable
    (block_ids [M] int64, used uint8 [L]) -> (dists [M, cb_k] int32,
    rows [M, cb_k] int32), ascending (distance, row), I32_MAX-padded (see
    ops/distance.DeviceRefiller). Output is bit-identical with or without
    the callback; a callback exception falls back to the host scan for
    that event.
    """
    nl = load()
    b, k = cand_d.shape
    cand_d = _c(cand_d, np.int32)
    cand_r = _c(cand_r, np.int32)
    blocks = _c(blocks, np.uint8)
    lib = _c(lib, np.uint8)
    out_row = np.empty(b, dtype=np.int32)
    out_dist = np.empty(b, dtype=np.int32)
    if refill_cb is None:
        rc = nl.emosaic_greedy_global(
            cand_d, cand_r, b, k, blocks, lib,
            lib.shape[0], lib.shape[1], num_tiles, out_row, out_dist,
        )
    else:
        L = lib.shape[0]
        if cb_k is None:
            # keep the engine's candidate width in lock-step with the
            # refiller's top-k width (a mismatch would shape-error every
            # event into the silent host-scan fallback)
            cb_k = getattr(refill_cb, "k", 256)

        warned = [False]

        def _trampoline(user, ids_ptr, m, used_ptr, out_d_ptr, out_r_ptr):
            try:
                ids = np.ctypeslib.as_array(ids_ptr, shape=(m,))
                used = np.ctypeslib.as_array(used_ptr, shape=(L,))
                d_, r_ = refill_cb(ids, used)
                np.ctypeslib.as_array(out_d_ptr, shape=(m, cb_k))[:] = d_
                np.ctypeslib.as_array(out_r_ptr, shape=(m, cb_k))[:] = r_
                return 0
            except Exception as e:  # engine falls back to its host scan
                # expected deferrals (DeviceRefiller._DeferRefill duck-typed
                # via this attribute — ops.distance must not be imported
                # here, this module stays jax-free for spawn prep workers)
                # fall back silently; anything else is logged once so a
                # misconfigured callback can't silently degrade to the
                # slow host-scan path
                if not getattr(e, "expected_fallback", False) and not warned[0]:
                    warned[0] = True
                    import sys, traceback

                    print(
                        "emosaic: device refill callback failed, falling "
                        f"back to host scans: {e!r}",
                        file=sys.stderr,
                    )
                    traceback.print_exc()
                return 1

        c_cb = _REFILL_CFUNC(_trampoline)  # keep alive for the call
        rc = nl.emosaic_greedy_global_cb(
            cand_d, cand_r, b, k, blocks, lib,
            lib.shape[0], lib.shape[1], num_tiles,
            c_cb, None, cb_k, cb_margin, cb_max_batch,
            out_row, out_dist,
        )
    if rc != 0:
        raise RuntimeError(f"emosaic_greedy_global rc={rc}")
    return out_row, out_dist


def trim_bounds(img: np.ndarray) -> tuple[int, int, int, int]:
    """Native white-trim scan; raises ValueError like io/prep.trim_bounds."""
    nl = load()
    img = _c(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        # the C++ scan indexes (y*w+x)*3+2 unconditionally — a grayscale
        # or RGBA array would read past the buffer (review r4)
        raise ValueError(f"trim_bounds needs [h, w, 3] u8, got {img.shape}")
    out = np.empty(4, dtype=np.int32)
    nl.emosaic_trim_bounds(img, img.shape[0], img.shape[1], out)
    if out[0] < 0:
        raise ValueError("image trims to nothing (all white?)")
    return int(out[0]), int(out[1]), int(out[2]), int(out[3])
