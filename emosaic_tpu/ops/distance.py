"""Fused L1 (Manhattan) distance + argmin matching kernels.

Replaces the reference's kiddo k-d tree nearest-neighbor search
(tileset.rs:178-190 `build_kiddo`, rendering.rs:186-196 `nearest_one/n`
with the Manhattan metric, rendering.rs:7) with dense batched device search:

- `build_library`: the [2T, 3N] library matrix with horizontally-flipped
  duplicates of every tile (mirrors tileset.rs:180-188: +idx for original,
  -idx for flipped — here encoded as row r < T -> item r+1, r >= T ->
  item -(r-T+1)).
- `l1_argmin_xla`: pure-XLA chunked scan, memory-safe for any B/L/D. The
  correctness oracle (and the CPU route).
- `l1_argmin`: the exact argmin on the route `ops/backend.py` picks — on
  the GPU the register-tiled Pallas-Triton kernel (`l1_argmin_triton`,
  D <= 256), the certified adaptive scorer (D <= 768) or the scan.
- `l1_topk`: exact top-k candidate lists for `--randomize`
  (rendering.rs:168-185) and no-repeat scoring (rendering.rs:307-321) —
  dense matrix + host argpartition at small B*L, certified adaptive /
  two-level device scorers at scale.

Distances are exact int32 (the reference matches on integer FixedU32<U0>
coordinates, tiles.rs:9). Tie-breaking is defined as *lowest library row
index wins* (original tiles in index order, then flipped tiles) — the
reference's kd-tree tie order is unspecified, so the parity oracle is
"equal distance" (SURVEY.md section 6).
"""

from __future__ import annotations

import concurrent.futures
import functools
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from emosaic_tpu.ops import backend

I32_MAX = np.int32(2**31 - 1)


# ---------------------------------------------------------------------------
# Library construction (flip augmentation + signed item ids)
# ---------------------------------------------------------------------------


def flip_palettes(palettes: jax.Array) -> jax.Array:
    """Horizontally mirror each palette's cell grid (utils.rs:18-43)."""
    t, n = palettes.shape[0], palettes.shape[1]
    dim = math.isqrt(n)
    if dim * dim != n:
        raise ValueError(f"N={n} is not a perfect square")
    return palettes.reshape(t, dim, dim, 3)[:, :, ::-1, :].reshape(t, n, 3)


def build_library(palettes) -> jax.Array:
    """Stack palettes + flipped palettes into a [2T, 3N] uint8 search matrix.

    Row r < T is tile r+1 unflipped; row r >= T is tile r-T+1 flipped,
    mirroring the +-idx double insertion of tileset.rs:180-188.
    """
    palettes = jnp.asarray(palettes, dtype=jnp.uint8)
    t = palettes.shape[0]
    flat = palettes.reshape(t, -1)
    flipped = flip_palettes(palettes).reshape(t, -1)
    return jnp.concatenate([flat, flipped], axis=0)


def rows_to_items(rows, num_tiles: int):
    """Library row -> signed 1-based item id (negative = flipped),
    the id convention of tileset.rs:131-143 `get_tile`."""
    rows = jnp.asarray(rows)
    return jnp.where(rows < num_tiles, rows + 1, -(rows - num_tiles + 1)).astype(
        jnp.int32
    )


def items_to_rows(items, num_tiles: int):
    """Signed item id -> library row."""
    items = jnp.asarray(items)
    return jnp.where(items > 0, items - 1, num_tiles - items - 1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Pure-XLA chunked scan (oracle + high-N fallback)
# ---------------------------------------------------------------------------


def _chunk_sizes(d: int, budget: int = 64 * 2**20) -> tuple[int, int]:
    """Pick (block_chunk, lib_chunk) so the [Bc, Lc, D] i32 diff fits budget."""
    bc = 1024
    lc = max(256, min(8192, budget // max(1, bc * d * 4)))
    while bc > 64 and bc * lc * d * 4 > budget:
        bc //= 2
    return bc, lc


@functools.partial(jax.jit, static_argnames=("d", "bc", "lc", "real_l"))
def _l1_argmin_xla_jit(blocks_flat, lib_flat, *, d: int, bc: int, lc: int, real_l: int):
    # flat 1D jit boundaries; the 2D views are inside-jit reshapes
    blocks = blocks_flat.reshape(-1, d)
    lib = lib_flat.reshape(-1, d)
    bp = blocks.shape[0]
    lp = lib.shape[0]
    nl = lp // lc
    lib_chunks = lib.reshape(nl, lc, d)

    def per_block_chunk(bchunk):  # [bc, d] u8
        bi = bchunk.astype(jnp.int32)

        def scan_lib(carry, inp):
            best_d, best_r = carry
            offset, lchunk = inp
            li = lchunk.astype(jnp.int32)
            dist = jnp.abs(bi[:, None, :] - li[None, :, :]).sum(
                axis=-1, dtype=jnp.int32
            )  # [bc, lc]
            col = offset + jnp.arange(lc, dtype=jnp.int32)[None, :]
            dist = jnp.where(col < real_l, dist, I32_MAX)
            local_arg = jnp.argmin(dist, axis=1).astype(jnp.int32)
            local_min = jnp.take_along_axis(dist, local_arg[:, None], axis=1)[:, 0]
            # Strictly-less update + ascending chunk order + argmin-first-wins
            # => global lowest-row-index tie-break.
            take = local_min < best_d
            best_d = jnp.where(take, local_min, best_d)
            best_r = jnp.where(take, offset + local_arg, best_r)
            return (best_d, best_r), None

        init = (
            jnp.full((bc,), I32_MAX, dtype=jnp.int32),
            jnp.zeros((bc,), dtype=jnp.int32),
        )
        offsets = jnp.arange(nl, dtype=jnp.int32) * lc
        (best_d, best_r), _ = jax.lax.scan(scan_lib, init, (offsets, lib_chunks))
        return best_d, best_r

    nb = bp // bc
    dists, rows = jax.lax.map(per_block_chunk, blocks.reshape(nb, bc, d))
    return dists.reshape(bp), rows.reshape(bp)


def l1_argmin_xla(blocks, lib) -> tuple[jax.Array, jax.Array]:
    """Exact L1 nearest library row for each block (pure XLA).

    Args:
      blocks: [B, D] uint8 query vectors.
      lib: [L, D] uint8 library matrix (see `build_library`).

    Returns:
      (dist [B] int32, row [B] int32) — minimal L1 distance and the library
      row achieving it (lowest row on ties).
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, d = blocks.shape
    l = lib.shape[0]
    bc, lc = _chunk_sizes(d)
    bc = min(bc, max(8, 1 << (b - 1).bit_length()))
    bp = -(-b // bc) * bc
    lp = -(-l // lc) * lc
    blocks_p = np.pad(blocks, ((0, bp - b), (0, 0)))
    lib_p = np.pad(lib, ((0, lp - l), (0, 0)))
    dist, row = _l1_argmin_xla_jit(
        jnp.asarray(blocks_p.reshape(-1)),
        jnp.asarray(lib_p.reshape(-1)),
        d=d,
        bc=bc,
        lc=lc,
        real_l=l,
    )
    return dist[:b], row[:b]


# ---------------------------------------------------------------------------
# Pallas-Triton kernel: register-tiled L1 distance + first-min argmin
#
# L1 has no tensor-core form, and XLA's broadcast-reduce re-reads block
# and library rows for every output element. This kernel keeps a
# [bm, bn] accumulator in registers, loops over D inside the tile, and
# folds the tile's (min, first argmin) into a running per-block winner
# while walking its library range in ascending row order. Blocks of a
# GPU grid run in no order, so the library axis is split into `splits`
# contiguous ranges (one grid column each, enough programs to fill the
# card); the per-split winners are combined afterwards by a
# (distance, split) argmin whose first-occurrence rule keeps the lowest
# library row on ties. Accumulation is f32: exact while 255 * D < 2^24.
# ---------------------------------------------------------------------------

#: (block rows, library columns) per program tile and launch shape: the
#: fastest of the sweep on an H100 at B = 16384, L = 65534 for D = 12,
#: 48 and 192 alike (docs/KERNELS.md)
_TRITON_BM = 128
_TRITON_BN = 128
_TRITON_WARPS = 4
_TRITON_STAGES = 2
#: grid programs to aim for (several waves over an H100's 132 SMs)
_TRITON_PROGRAMS = 1024
#: masked-column sentinel (above any real distance, exact in f32)
_TRITON_BIG = np.float32(2**30)


def _l1_triton_kernel(
    xt_ref, lt_ref, dist_ref, row_ref, *, d, bm, bn, tiles, real_l
):
    """One (block tile i, library split s) program.

    xt_ref: [D, Bp] u8 transposed queries; lt_ref: [D, Lp] u8 transposed
    library (both whole arrays — loads of one feature row are coalesced).
    dist_ref / row_ref: [splits, Bp] i32 per-split winners."""
    i = pl.program_id(0)
    s = pl.program_id(1)
    xs = pl.ds(i * bm, bm)

    def l_tile(j, carry):
        best_d, best_r = carry
        col0 = (s * tiles + j) * bn

        def d_step(k, acc):
            x = xt_ref[k, xs].astype(jnp.float32)
            t = lt_ref[k, pl.ds(col0, bn)].astype(jnp.float32)
            return acc + jnp.abs(x[:, None] - t[None, :])

        acc = jax.lax.fori_loop(0, d, d_step, jnp.zeros((bm, bn), jnp.float32))
        col = col0 + jax.lax.broadcasted_iota(jnp.int32, (bm, bn), 1)
        acc = jnp.where(col < real_l, acc, _TRITON_BIG)
        tmin = jnp.min(acc, axis=1)
        targ = jnp.min(jnp.where(acc == tmin[:, None], col, I32_MAX), axis=1)
        # strictly-less across ascending tiles: the lowest row keeps a tie
        take = tmin < best_d
        return jnp.where(take, tmin, best_d), jnp.where(take, targ, best_r)

    init = (
        jnp.full((bm,), _TRITON_BIG, jnp.float32),
        jnp.zeros((bm,), jnp.int32),
    )
    best_d, best_r = jax.lax.fori_loop(0, tiles, l_tile, init)
    dist_ref[s, xs] = best_d.astype(jnp.int32)
    row_ref[s, xs] = best_r


def _triton_splits(b: int, l: int, bm: int, bn: int) -> int:
    """Library splits so the grid holds about `_TRITON_PROGRAMS` programs
    (never more splits than library tiles)."""
    nb = max(1, -(-b // bm))
    return max(1, min(-(-l // bn), _TRITON_PROGRAMS // nb))


def _triton_span(
    b: int, l: int, d: int, bm: int = _TRITON_BM, bn: int = _TRITON_BN
) -> int:
    """Element count of the kernel's larger operand, [D, Bp] or [D, Lp]
    (padded as `_l1_argmin_triton_jit` pads them): its flat offsets must
    stay under `backend.TRITON_INDEX_LIMIT`."""
    splits = _triton_splits(b, l, bm, bn)
    lp = -(-(-(-l // bn)) // splits) * splits * bn
    bp = -(-b // bm) * bm
    return d * max(bp, lp)


@functools.partial(
    jax.jit,
    static_argnames=(
        "real_l", "bm", "bn", "splits", "num_warps", "num_stages", "interpret"
    ),
)
def _l1_argmin_triton_jit(
    blocks, lib, *, real_l, bm, bn, splits, num_warps, num_stages,
    interpret=False,
):
    b, d = blocks.shape
    l = lib.shape[0]
    tiles = -(-(-(-l // bn)) // splits)
    lp = tiles * splits * bn
    bp = -(-b // bm) * bm
    xt = jnp.pad(blocks, ((0, bp - b), (0, 0))).T
    lt = jnp.pad(lib, ((0, lp - l), (0, 0))).T
    kernel = functools.partial(
        _l1_triton_kernel, d=d, bm=bm, bn=bn, tiles=tiles, real_l=real_l
    )
    dist, row = pl.pallas_call(
        kernel,
        grid=(bp // bm, splits),
        out_shape=[jax.ShapeDtypeStruct((splits, bp), jnp.int32)] * 2,
        backend="triton",
        interpret=interpret,
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        name="l1_argmin_triton",
    )(xt, lt)
    # splits cover ascending row ranges: the first split reaching the
    # minimum holds the lowest tied row
    s = jnp.argmin(dist, axis=0)[None]
    dist = jnp.take_along_axis(dist, s, axis=0)[0, :b]
    row = jnp.take_along_axis(row, s, axis=0)[0, :b]
    return dist, row


def l1_argmin_triton(
    blocks, lib, *, interpret: bool = False, bm: int = _TRITON_BM,
    bn: int = _TRITON_BN,
) -> tuple[jax.Array, jax.Array]:
    """Exact L1 argmin through the Pallas-Triton kernel (same contract as
    `l1_argmin_xla`; D <= `backend.TRITON_MAX_D`, operands under
    `backend.TRITON_INDEX_LIMIT` elements). `interpret=True` runs the
    kernel body through the Pallas interpreter, which is how the CPU tests
    reach it; `bm`/`bn` let them use small tiles."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, d = blocks.shape
    l = lib.shape[0]
    if d > backend.TRITON_MAX_D:
        raise ValueError(
            f"Triton L1 kernel takes D <= {backend.TRITON_MAX_D}, got {d}"
        )
    span = _triton_span(b, l, d, bm, bn)
    if span >= backend.TRITON_INDEX_LIMIT:
        raise ValueError(
            f"Triton L1 kernel operands of {span} elements pass its 32-bit "
            f"offsets ({backend.TRITON_INDEX_LIMIT})"
        )
    return _l1_argmin_triton_jit(
        jnp.asarray(blocks),
        jnp.asarray(lib),
        real_l=l,
        bm=bm,
        bn=bn,
        splits=_triton_splits(b, l, bm, bn),
        num_warps=_TRITON_WARPS,
        num_stages=_TRITON_STAGES,
        interpret=interpret,
    )


def l1_argmin(blocks, lib):
    """Exact L1 nearest library row per block, on the route
    `backend.argmin_route` picks for this device and feature dim.

    Same contract as `l1_argmin_xla` (the oracle, and the CPU route).
    Supports every mode's feature dim (up to 3N = 49152 for mode 128).

    Returns (dist [B], row [B]) as int32 arrays — device (jax) arrays on
    most routes, numpy on the adaptive and streamed routes (they finish
    with host-side stitching); callers np.asarray the result.
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    d = blocks.shape[1]
    l = lib.shape[0]
    if lib.size > _lib_budget() and l > _TL_SEG:
        # beyond the device-resident budget every direct kernel would OOM
        # uploading the library; stream host banks (exact — k=1 keeps the
        # lowest-row tie-break through the cross-bank merge). numpy out.
        da, ra = l1_topk_streamed(blocks, lib, 1)
        return da[:, 0], ra[:, 0]
    route = backend.argmin_route(
        backend.platform(), d, _triton_span(blocks.shape[0], l, d)
    )
    if route == "triton":
        return l1_argmin_triton(blocks, lib)
    if route == "adaptive":
        # k=1 keeps the exact lowest-row tie-break (strict certificate)
        da, ra = l1_topk_adaptive(blocks, lib, 1)
        return da[:, 0], ra[:, 0]
    return l1_argmin_xla(blocks, lib)


@functools.partial(jax.jit, static_argnames=("d", "bc", "real_l"))
def _l1_argmin_stripes_jit(blocks_flat, lib_flat, *, d: int, bc: int, real_l: int):
    """Min-identity distance stripes + first-min argmin (lowest-row ties).

    dist[b, l] = cx[b] + ct[l] - 2*sum_d min(x, t); the per-block cx shift
    preserves per-row ordering, so argmin runs on the score and the true
    distance is recovered by adding cx (exact int32 identity; one op per
    element fewer than the abs-diff form).
    """
    blocks = blocks_flat.reshape(-1, d)
    lib = lib_flat.reshape(-1, d)
    col = jnp.arange(lib.shape[0], dtype=jnp.int32)
    invalid = col >= real_l
    score_of = _stripe_score_env(lib, invalid)

    def per_chunk(xc):
        score = score_of(xc)
        row = jnp.argmin(score, axis=1).astype(jnp.int32)
        best = jnp.take_along_axis(score, row[:, None], axis=1)[:, 0]
        cx = xc.astype(jnp.int32).sum(-1)
        return best + cx, row

    nb = blocks.shape[0] // bc
    dists, rows = jax.lax.map(per_chunk, blocks.reshape(nb, bc, d))
    return dists.reshape(-1), rows.reshape(-1)


def l1_argmin_stripes(blocks, lib) -> tuple[jax.Array, jax.Array]:
    """Exact L1 argmin via min-identity stripes (the high-D matched-mode
    path; same contract as `l1_argmin_xla`)."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, d = blocks.shape
    l = lib.shape[0]
    bc = min(_STRIPE_BC, max(8, 1 << (b - 1).bit_length()))
    bp = -(-b // bc) * bc
    blocks_p = np.pad(blocks, ((0, bp - b), (0, 0)))
    dist, row = _l1_argmin_stripes_jit(
        jnp.asarray(blocks_p.reshape(-1)),
        jnp.asarray(lib.reshape(-1)),
        d=d,
        bc=bc,
        real_l=l,
    )
    return dist[:b], row[:b]


# ---------------------------------------------------------------------------
# Fused distance stripes (exact high-D path: argmin and top-k)
#
# XLA fuses the [bc, L, D] broadcast-min-reduce into one loop fusion, so
# the [bc, L, D] intermediate never exists. The top-k scorers build on
# them; for the argmin alone the H100 measured other routes faster at
# every D (ops/backend.py, docs/KERNELS.md).
# ---------------------------------------------------------------------------

_STRIPE_BC = 128

#: run the stripe reduction in f32 when the one-time f32 library copy
#: fits this budget (exact: operands are u8-valued, every partial sum
#: < 2^24). f32 against i32 accumulation is not measured on the H100.
_STRIPE_F32_MAX_BYTES = 3 << 30


def _stripe_f32_ok(lib_elems: int) -> bool:
    return lib_elems * 4 <= _STRIPE_F32_MAX_BYTES


def _min_sum_stripe(xc, lib_w, f32: bool):
    """sum_d min(x, t) for one block chunk against the whole library
    (the stripe inner loop; XLA fuses it — [bc, L, D] never exists).
    When f32=True, `lib_w` must be the f32 library copy (materialized
    once outside the chunk loop)."""
    if f32:
        return (
            jnp.minimum(xc.astype(jnp.float32)[:, None, :], lib_w[None])
            .sum(-1, dtype=jnp.float32)
            .astype(jnp.int32)
        )
    return (
        jnp.minimum(xc[:, None, :], lib_w[None])
        .astype(jnp.int32)
        .sum(-1, dtype=jnp.int32)
    )


@functools.partial(jax.jit, static_argnames=("d", "bc", "k", "real_l"))
def _l1_topk_stripes_jit(blocks_flat, lib_flat, *, d, bc, k, real_l):
    blocks = blocks_flat.reshape(-1, d)
    lib = lib_flat.reshape(-1, d)
    col = jnp.arange(lib.shape[0], dtype=jnp.int32)
    invalid = col >= real_l
    # min-identity form (see _l1_argmin_stripes_jit): score ordering ==
    # distance ordering per row (cx is a per-block constant), so top_k on
    # the score keeps the lowest-column tie rule and the true distance is
    # recovered as score + cx
    score_of = _stripe_score_env(lib, invalid)

    def per_chunk(xc):
        score = score_of(xc)
        nd, ni = jax.lax.top_k(-score, k)  # ties -> lowest column index
        cx = xc.astype(jnp.int32).sum(-1)
        dist = jnp.where(-nd >= _TL_BIG, I32_MAX, -nd + cx[:, None])
        return dist, ni

    nb = blocks.shape[0] // bc
    dists, rows = jax.lax.map(per_chunk, blocks.reshape(nb, bc, d))
    return dists.reshape(-1, k), rows.reshape(-1, k)


def l1_topk_stripes(blocks, lib, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact k nearest rows per block via fused distance stripes.

    Same contract as `l1_topk` (ascending by (distance, row); I32_MAX
    padding when k > L) but computed as full-library stripes with a
    device top_k — the fast exact path for high-D no-repeat scoring
    (rendering.rs:307-321's candidate lists at production scale).
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, d = blocks.shape
    l = lib.shape[0]
    kk = min(k, l)
    bc = min(_STRIPE_BC, max(8, 1 << (b - 1).bit_length()))
    bp = -(-b // bc) * bc
    blocks_p = np.pad(blocks, ((0, bp - b), (0, 0)))
    dists, rows = _l1_topk_stripes_jit(
        jnp.asarray(blocks_p.reshape(-1)),
        jnp.asarray(lib.reshape(-1)),
        d=d,
        bc=bc,
        k=kk,
        real_l=l,
    )
    out_d = np.asarray(jax.device_get(dists))[:b]
    out_r = np.asarray(jax.device_get(rows))[:b]
    return _pad_topk(out_d, out_r, b, k, kk)


# ---------------------------------------------------------------------------
# Batched device refill for the no-repeat assignment engines
#
# Under tail contention (assigned blocks approaching the 2T admission
# bound) the C++ greedy engine's host refill — an AVX2 masked scan per
# exhausted block (native/emosaic_native.cpp masked_topk) — dominates
# assignment time at full-library consumption. The device refiller
# replaces it with ONE stripes+top_k call per refill event covering every
# nearly-dry block, over the library COMPACTED to its unused rows: under
# tail contention the unused set is tiny, so each event is one small
# device call instead of thousands of host scans of the whole library. Results are exact ascending (distance, row) with the
# lowest-row tie rule — the compaction index is ascending, so top_k's
# earliest-position tie preference maps back to the lowest original row.
#
# Shape discipline (every fresh shape is a compile): block ids
# are padded to one fixed M2 and the unused set to one of two widths
# (_REFILL_TAIL_U for the tail regime, pow2(L) for early refills), so a
# whole assignment run compiles at most two kernel shapes. The unused
# count crosses the kernel as a *traced* scalar.
# ---------------------------------------------------------------------------

#: compacted-library width for the tail-contention regime; refill events
#: with more unused rows take the full pow2(L) shape
_REFILL_TAIL_U = 16384

#: host-scan refill events a cold DeviceRefiller absorbs before paying
#: its one-time blocks+library upload: few-refill runs never upload;
#: mass-refill runs switch to the device after this many. Not measured
#: on the H100 (its PCIe upload of a flagship library is a fraction of a
#: second); EMOSAIC_DEVICE_REFILL_DEFER can change it (or warm() skips
#: deferral entirely).
_REFILL_DEFER_EVENTS = 256


class _DeferRefill(Exception):
    """Raised to route one refill event back to the host masked scan.

    `expected_fallback` marks this as deliberate control flow for the
    native-trampoline's failure logging (native.py, which stays jax-free
    and so cannot import this class)."""

    expected_fallback = True


@functools.partial(jax.jit, static_argnames=("d", "k", "bc"))
def _refill_topk_jit(blocks_flat, ids, lib_flat, unused_idx, real_u, *, d, k, bc):
    blocks = blocks_flat.reshape(-1, d)
    lib = lib_flat.reshape(-1, d)
    xb = blocks[ids]  # [M2, d] device-side block gather
    sub = lib[unused_idx]  # [U2, d] compacted (ascending) unused rows
    u2 = sub.shape[0]
    invalid = jnp.arange(u2, dtype=jnp.int32) >= real_u
    score_of = _stripe_score_env(sub, invalid)

    def per_chunk(xc):
        score = score_of(xc)
        nd, ni = jax.lax.top_k(-score, k)  # ties -> lowest compacted pos
        cx = xc.astype(jnp.int32).sum(-1)
        dist = jnp.where(-nd >= _TL_BIG, I32_MAX, -nd + cx[:, None])
        rows = jnp.where(dist == I32_MAX, 0, jnp.take(unused_idx, ni))
        return dist, rows

    nb = xb.shape[0] // bc
    dists, rows = jax.lax.map(per_chunk, xb.reshape(nb, bc, d))
    return dists.reshape(-1, k), rows.reshape(-1, k)


class DeviceRefiller:
    """Batched masked top-k refill engine (native.greedy_global callback).

    Callable as (block_ids [M] int, used uint8/bool [L]) ->
    (dists [M, k] int32, rows [M, k] int32), ascending (distance, row)
    over the rows with used[r] == 0, I32_MAX-padded — the exact contract
    of the C++ engine's host masked_topk (and of rendering.rs:383-385's
    live-tree re-fetch, whose mutating kd-tree this mask replaces).

    Blocks and library upload lazily on the first refill event and stay
    device-resident across events.
    """

    def __init__(self, blocks, lib, *, k: int = 256, defer_events: int | None = None):
        self._blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
        self._lib = np.ascontiguousarray(lib, dtype=np.uint8)
        self.b, self.d = self._blocks.shape
        self.l = self._lib.shape[0]
        self.k = k
        #: public: the padded query-batch capacity per device call —
        #: callers cap their refill batches to this (render/norepeat.py)
        self.max_batch = 1 << (min(self.b, 4096) - 1).bit_length()
        self._m2 = self.max_batch
        self._l2 = 1 << (self.l - 1).bit_length()
        self._blocks_dev = None
        self._lib_dev = None
        self.n_calls = 0
        if defer_events is None:
            defer_events = int(
                os.environ.get("EMOSAIC_DEVICE_REFILL_DEFER", _REFILL_DEFER_EVENTS)
            )
        self.defer_events = defer_events
        self.n_deferred = 0

    def warm(self) -> None:
        """Upload blocks/library and compile both refill shapes ahead of
        assignment — otherwise the first refill event pays the upload
        (~1.2 GB at flagship scale) plus a fresh XLA compile mid-run."""
        if self._lib.nbytes > _lib_budget():
            return  # beyond-budget library: events stay on the host scan
        if self._blocks_dev is None:
            self._blocks_dev = jnp.asarray(self._blocks.reshape(-1))
            self._lib_dev = jnp.asarray(self._lib.reshape(-1))
        for u2 in {min(self._l2, _REFILL_TAIL_U), self._l2}:
            d_, _ = _refill_topk_jit(
                self._blocks_dev,
                jnp.zeros(self._m2, jnp.int32),
                self._lib_dev,
                jnp.zeros(u2, jnp.int32),
                jnp.int32(1),
                d=self.d,
                k=min(self.k, u2),
                bc=min(_STRIPE_BC, self._m2),
            )
            jax.device_get(d_[0, 0])

    def __call__(self, ids: np.ndarray, used: np.ndarray):
        m = len(ids)
        out_d = np.full((m, self.k), I32_MAX, np.int32)
        out_r = np.zeros((m, self.k), np.int32)
        unused = np.flatnonzero(np.asarray(used) == 0).astype(np.int32)
        if unused.size == 0:
            return out_d, out_r
        if self._lib.nbytes > _lib_budget():
            # beyond the device-resident budget the lazy upload would OOM
            # the chip; keep EVERY event on the engine's exact host scan
            # (the C++ engine treats the raise as a per-event fallback)
            raise _DeferRefill(-1)
        if self._blocks_dev is None and self.n_deferred < self.defer_events:
            # cold: absorb early events on the host scan until the upload
            # is worth paying (the engine falls back per-event on raise)
            self.n_deferred += 1
            raise _DeferRefill(self.n_deferred)
        if self._blocks_dev is None:
            self._blocks_dev = jnp.asarray(self._blocks.reshape(-1))
            self._lib_dev = jnp.asarray(self._lib.reshape(-1))
        u2 = min(
            self._l2,
            _REFILL_TAIL_U if unused.size <= _REFILL_TAIL_U else self._l2,
        )
        kk = min(self.k, u2)
        unused_p = np.zeros(u2, np.int32)
        unused_p[: unused.size] = unused
        unused_dev = jnp.asarray(unused_p)
        real_u = jnp.int32(unused.size)
        ids = np.asarray(ids, dtype=np.int32)
        for lo in range(0, m, self._m2):  # normally a single chunk
            chunk = ids[lo : lo + self._m2]
            ids_p = np.zeros(self._m2, np.int32)
            ids_p[: len(chunk)] = chunk
            d_, r_ = _refill_topk_jit(
                self._blocks_dev,
                jnp.asarray(ids_p),
                self._lib_dev,
                unused_dev,
                real_u,
                d=self.d,
                k=kk,
                bc=min(_STRIPE_BC, self._m2),
            )
            self.n_calls += 1
            # one fused host pull: each device_get is a host round trip,
            # and refill events can number in the thousands
            d_h, r_h = jax.device_get((d_, r_))
            out_d[lo : lo + self._m2, :kk] = np.asarray(d_h)[: len(chunk)]
            out_r[lo : lo + self._m2, :kk] = np.asarray(r_h)[: len(chunk)]
        return out_d, out_r


# ---------------------------------------------------------------------------
# Hybrid: bf16 matmul L2 prefilter (approx_min_k) + exact-L1 rescore
#
# The squared-L2 prefilter is a [B, D] x [D, L] bf16 matmul (tensor
# cores; u8 values are exact in bf16). APPROXIMATE: candidates come from
# squared-L2 ordering (plus approx_min_k's recall), then are re-ranked
# and distanced in exact int32 L1, but exactness is NOT guaranteed;
# opt-in via --matcher hybrid (PARITY deviation). Not measured on the
# H100.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("d", "bc", "k_pre"))
def _l2_prefilter_jit(blocks_flat, lib_flat, *, d, bc, k_pre):
    x = blocks_flat.reshape(-1, d)
    t = lib_flat.reshape(-1, d)
    t_bf = t.astype(jnp.bfloat16).T
    t_norm = (t.astype(jnp.float32) ** 2).sum(axis=1)

    def per_chunk(xc):
        g = jax.lax.dot_general(
            xc.astype(jnp.bfloat16),
            t_bf,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        score = t_norm[None, :] - 2.0 * g
        _, idx = jax.lax.approx_min_k(score, k_pre)
        return idx.astype(jnp.int32)

    nb = x.shape[0] // bc
    return jax.lax.map(per_chunk, x.reshape(nb, bc, d)).reshape(-1, k_pre)


@functools.partial(jax.jit, static_argnames=("d", "bc", "k", "real_l"))
def _l1_rescore_jit(blocks_flat, cand_rows, lib_flat, *, d, bc, k, real_l):
    blocks = blocks_flat.reshape(-1, d)
    lib = lib_flat.reshape(-1, d)
    b = blocks.shape[0]
    k_pre = cand_rows.shape[1]
    nb = b // bc
    # candidates ascending by row: top_k prefers earlier positions on
    # value ties, so equal distances resolve to the lowest library
    # row, matching the exact kernels' tie-break
    cand = jnp.sort(cand_rows, axis=1)

    def per_chunk(args):
        xc, cr = args
        tc = lib[cr]  # [bc, k_pre, D] row gather
        dist = jnp.abs(
            xc.astype(jnp.int32)[:, None, :] - tc.astype(jnp.int32)
        ).sum(-1, dtype=jnp.int32)
        dist = jnp.where(cr < real_l, dist, I32_MAX)
        nd, ni = jax.lax.top_k(-dist, k)
        return -nd, jnp.take_along_axis(cr, ni, axis=1)

    dists, rows = jax.lax.map(
        per_chunk, (blocks.reshape(nb, bc, d), cand.reshape(nb, bc, k_pre))
    )
    return dists.reshape(-1, k), rows.reshape(-1, k)


def l1_topk_hybrid(
    blocks, lib, k: int, *, k_pre: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Approximate k nearest rows: matmul L2 prefilter, exact-L1 rescore.

    Returned distances are exact int32 L1 for the returned rows; the
    candidate *set* is L2-preselected (see module comment). k_pre defaults
    to max(2k, 64) capped at the library size.
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, d = blocks.shape
    l = lib.shape[0]
    if lib.size > _lib_budget() and l > _TL_SEG:
        # the matmul prefilter needs the whole library device-resident;
        # past the budget, stream exact host banks instead — a STRONGER
        # result (exact candidate set) at streamed-bank cost
        return l1_topk_streamed(blocks, lib, k)
    if l <= max(k * 2, 256):
        return l1_topk_stripes(blocks, lib, k)  # small library: exact
    kp = min(k_pre or max(2 * k, 64), l)
    kk = min(k, kp)
    # power-of-two chunk so the rescore chunk bc2 (also a power of two)
    # always divides the padded block count — an arbitrary bc makes
    # _l1_rescore_jit's reshape(nb, bc2, ...) fail for most library sizes
    raw = (2**26) // max(1, l * 4)
    bc = max(8, min(1024, 1 << (max(1, raw).bit_length() - 1)))
    bp = -(-b // bc) * bc
    blocks_p = np.pad(blocks, ((0, bp - b), (0, 0)))
    # one upload each, shared by the prefilter and rescore jits (a second
    # jnp.asarray would re-pay the host->device transfer AND double the
    # transient device memory for the library)
    blocks_dev = jnp.asarray(blocks_p.reshape(-1))
    lib_dev = jnp.asarray(lib.reshape(-1))
    cand = _l2_prefilter_jit(
        blocks_dev,
        lib_dev,
        d=d,
        bc=bc,
        k_pre=kp,
    )
    bc2 = min(256, bc)
    dists, rows = _l1_rescore_jit(
        blocks_dev,
        cand,
        lib_dev,
        d=d,
        bc=bc2,
        k=kk,
        real_l=l,
    )
    out_d = np.asarray(jax.device_get(dists))[:b]
    out_r = np.asarray(jax.device_get(rows))[:b]
    return _pad_topk(out_d, out_r, b, k, kk)


def l1_argmin_hybrid(blocks, lib, *, k_pre: int = 64):
    """Approximate nearest row (exact L1 distance of the winner) via the
    matmul prefilter + rescore. The high-N fast mode."""
    d, r = l1_topk_hybrid(blocks, lib, 1, k_pre=k_pre)
    return d[:, 0], r[:, 0]


# ---------------------------------------------------------------------------
# Full distance matrix (exact no-repeat candidate lists)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("d", "bc"))
def _l1_matrix_jit(blocks_flat, lib_flat, *, d: int, bc: int):
    blocks = blocks_flat.reshape(-1, d)
    lib = lib_flat.reshape(-1, d).astype(jnp.int32)

    def per_chunk(bchunk):
        return jnp.abs(
            bchunk.astype(jnp.int32)[:, None, :] - lib[None, :, :]
        ).sum(axis=-1, dtype=jnp.int32)

    nb = blocks.shape[0] // bc
    return jax.lax.map(per_chunk, blocks.reshape(nb, bc, d)).reshape(
        blocks.shape[0], lib.shape[0]
    )


def l1_dist_matrix(blocks, lib) -> np.ndarray:
    """Full [B, L] int32 L1 distance matrix (host numpy).

    Used by the exact global-greedy no-repeat path: with the reference's
    32767-tile cap its 100k-NN candidate fetch is simply the full sorted
    list per block (rendering.rs:320; SURVEY §2 R17), and sorting a dense
    matrix on the host beats a running device top-k at k = L by orders of
    magnitude.
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, d = blocks.shape
    bc, _ = _chunk_sizes(d)
    bc = min(bc, max(8, 1 << (b - 1).bit_length()))
    bp = -(-b // bc) * bc
    blocks_p = np.pad(blocks, ((0, bp - b), (0, 0)))
    out = _l1_matrix_jit(
        jnp.asarray(blocks_p.reshape(-1)),
        jnp.asarray(lib.reshape(-1)),
        d=d,
        bc=bc,
    )
    return np.asarray(jax.device_get(out))[:b]


# ---------------------------------------------------------------------------
# Matmul L2 fast mode (opt-in --metric l2; the reference is L1-only)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("d", "bc", "real_l"))
def _l2_argmin_jit(blocks_flat, lib_flat, *, d: int, bc: int, real_l: int):
    """Squared-L2 argmin via a bf16 matmul: dist^2 = |x|^2 - 2 x.t + |t|^2; the
    |x|^2 term is constant per query and dropped for the argmin. Inputs are
    u8 -> bf16 (exact: integers < 256), accumulation in f32 — argmin is
    exact while 2*255^2*D < 2^24 (any N <= 42) and within float rounding
    above; the winner's distance is recomputed exactly in int32."""
    x = blocks_flat.reshape(-1, d)
    t = lib_flat.reshape(-1, d)
    lp = t.shape[0]
    t_bf = t.astype(jnp.bfloat16)
    t_norm = (t.astype(jnp.float32) ** 2).sum(axis=1)  # [L]
    col = jnp.arange(lp, dtype=jnp.int32)
    invalid = col >= real_l

    def per_chunk(xc):
        g = jax.lax.dot_general(
            xc.astype(jnp.bfloat16),
            t_bf.T,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [bc, L]
        score = t_norm[None, :] - 2.0 * g
        score = jnp.where(invalid[None, :], jnp.inf, score)
        row = jnp.argmin(score, axis=1).astype(jnp.int32)
        # exact int32 squared distance for the winner
        tw = t[row].astype(jnp.int32)
        diff = xc.astype(jnp.int32) - tw
        return (diff * diff).sum(axis=1, dtype=jnp.int32), row

    nb = x.shape[0] // bc
    dists, rows = jax.lax.map(per_chunk, x.reshape(nb, bc, d))
    return dists.reshape(-1), rows.reshape(-1)


def l2_argmin(blocks, lib) -> tuple[jax.Array, jax.Array]:
    """Nearest library row under squared L2, matmul path.

    A performance-mode addition over the reference (which matches in L1
    only, rendering.rs:7): for large N the tensor cores turn the distance
    computation into a [B, D] x [D, 2T] bf16 matmul. Returns
    (dist_sq [B] int32, row [B] int32); ties may resolve differently from
    the L1 kernels (float argmin picks the first minimum).
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, d = blocks.shape
    l = lib.shape[0]
    if 3 * lib.nbytes > _lib_budget() and l > _TL_SEG:
        # the matmul path keeps the u8 library PLUS a 2x bf16 copy resident
        # (~3x lib bytes) — the only matcher whose working set is a
        # multiple of the library. Past the budget, stream host banks
        # through this same kernel (bank thirds keep the 3x inside the
        # envelope; bank-local "first minimum" ties fold under the
        # streamer's (dist, lowest-row) key — this mode's ties are
        # documented as kernel-dependent already).
        rb = max(_TL_SEG, _lib_budget() // 3 // d // _TL_SEG * _TL_SEG)

        def bank_scorer(bb, ll, kx, prepared=None):
            dd_, rr_ = l2_argmin(bb, ll)
            return np.asarray(dd_)[:, None], np.asarray(rr_)[:, None]

        da, ra = l1_topk_streamed(blocks, lib, 1, bank_rows=rb, scorer=bank_scorer)
        return da[:, 0], ra[:, 0]
    bc = max(8, min(2048, (2**26) // max(1, l * 4)))
    bp = -(-b // bc) * bc
    blocks_p = np.pad(blocks, ((0, bp - b), (0, 0)))
    dist, row = _l2_argmin_jit(
        jnp.asarray(blocks_p.reshape(-1)),
        jnp.asarray(lib.reshape(-1)),
        d=d,
        bc=bc,
        real_l=l,
    )
    return dist[:b], row[:b]


# ---------------------------------------------------------------------------
# Top-k dispatch (for --randomize and no-repeat candidate lists).
# The old chunked running-scan kernel was deleted after being superseded
# end-to-end: dense matrix + host argpartition below the matrix budget,
# the adaptive/two-level certified scorers above it (both 20x+ faster at
# scale than the running scan).
# ---------------------------------------------------------------------------


def _pad_topk(out_d, out_r, b: int, k: int, kk: int):
    """Shared top-k padding convention: when k exceeds the available rows
    (kk), trailing entries carry I32_MAX distances and row 0."""
    if kk < k:
        out_d = np.concatenate(
            [out_d, np.full((b, k - kk), I32_MAX, np.int32)], axis=1
        )
        out_r = np.concatenate(
            [out_r, np.zeros((b, k - kk), np.int32)], axis=1
        )
    return out_d, out_r


def _stripe_fallback(out_d, out_r, bad, blocks, lib, kk: int):
    """Shared uncertified-row fallback: exact stripe recompute for `bad`
    rows, merged into (copies of) the outputs."""
    if bad.size:
        out_d = out_d.copy()  # device_get buffers are read-only
        out_r = out_r.copy()
        fd, fr = l1_topk_stripes(blocks[bad], lib, kk)
        out_d[bad] = fd
        out_r[bad] = fr
    return out_d, out_r


#: dense-matrix + host-argpartition path while B * L stays under this
_TOPK_MATRIX_BUDGET = 2 * 10**8


def l1_topk(blocks, lib, k: int) -> tuple[np.ndarray, np.ndarray]:
    """k nearest library rows per block, ascending by (distance, row).

    Replaces kiddo `nearest_n` (rendering.rs:172-174 k=20 for --randomize;
    rendering.rs:307-321 candidate lists for global-greedy no-repeat).
    Dispatches between a dense-matrix + host argpartition path (small
    B*L) and the certified two-level device top-k (everything larger —
    the stripe+lax.top_k path it supersedes was itself 21x the old
    running-top-k scan at flagship no-repeat scale).

    Returns:
      (dists [B, k] int32, rows [B, k] int32) numpy. If k > L, trailing
      entries carry I32_MAX distances.
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, l = blocks.shape[0], lib.shape[0]
    if b * l > _TOPK_MATRIX_BUDGET or (
        lib.size > _lib_budget() and l > _TL_SEG
    ):
        # the adaptive certified scorer self-gates: unsuitable shapes or
        # concentrated data reroute to the direct two-level scorer, so
        # this is exact everywhere and ~3x faster on clusterable data.
        # Beyond-budget libraries must also go this way regardless of B:
        # l1_dist_matrix would upload the whole library, while the
        # adaptive gate streams host banks (l1_topk_streamed)
        return l1_topk_adaptive(blocks, lib, k)
    kk = min(k, l)
    dist = l1_dist_matrix(blocks, lib)
    # exact lexicographic (distance, row) selection: a plain argpartition
    # on distances picks arbitrary tie members at the kth boundary, so
    # partition on a packed int64 key instead
    key = dist.astype(np.int64) * l + np.arange(l, dtype=np.int64)[None, :]
    if kk < l:
        part = np.argpartition(key, kk - 1, axis=1)[:, :kk]
    else:
        part = np.broadcast_to(np.arange(l), (dist.shape[0], l)).copy()
    pk = np.take_along_axis(key, part, axis=1)
    order = np.argsort(pk, axis=1)
    out_r = np.take_along_axis(part, order, axis=1).astype(np.int32)
    out_d = (np.take_along_axis(pk, order, axis=1) // l).astype(np.int32)
    return _pad_topk(out_d, out_r, b, k, kk)


# ---------------------------------------------------------------------------
# Two-level exact top-k (fast no-repeat scoring at production scale)
#
# lax.top_k(k=512) over a [B, 65534] stripe costs ~3 s of the 4.5 s
# flagship scoring (its work scales with L*k). Splitting the library axis
# into 128-column segments and keeping only `cap` entries per segment
# shrinks the expensive global top-k input by 128/cap while staying
# EXACT for the rows it certifies: a segment can only hide a missed
# candidate if its cap-th (worst kept) value is <= the global k-th value,
# and that condition is checked per row — uncertified rows (pathological
# distance ties/clustering) are recomputed with the plain stripe kernel.
# The strict `>` in the certificate also covers tie-break parity: a
# truncated entry tied with the k-th value could have a lower library row
# than a kept tie, so ties at the k-th value force the fallback too.
# ---------------------------------------------------------------------------

#: library columns per stage-1 segment (lane-width aligned)
_TL_SEG = 128
#: stage-1 survivors per segment; a row certifies iff no segment held
#: more than _TL_CAP of its true top-k
_TL_CAP = 8


#: invalid-column sentinel for the min-identity score space (score + the
#: per-block constant stays far below this, so masked columns never win)
_TL_BIG = np.int32(2**30)

def _stripe_score_env(lib, invalid):
    """Shared min-identity stripe scoring prefix (one body for the four
    stripe kernels).

    Precomputes the per-column coordinate sums, takes the f32-lane
    decision (`_stripe_f32_ok` — exact below 2^24), and returns a
    `score_of(xc)` closure: score[i, j] = ct[j] - 2*sum_min(x_i, t_j)
    with invalid columns forced to `_TL_BIG`. By the min identity
    |x-t| = x + t - 2*min(x,t), dist = score + cx where cx = sum(x_i) is
    a per-block constant — so score ordering equals distance ordering,
    ties included. Chip-exactness-sensitive: every stripe kernel must
    take this construction from here, not re-derive it."""
    ct = lib.astype(jnp.int32).sum(axis=1)
    f32 = _stripe_f32_ok(lib.size)
    lib_w = lib.astype(jnp.float32) if f32 else lib

    def score_of(xc):
        s = _min_sum_stripe(xc, lib_w, f32)  # fused stripe: [bc, L]
        score = ct[None, :] - 2 * s
        return jnp.where(invalid[None, :], _TL_BIG, score)

    return score_of



@functools.partial(jax.jit, static_argnames=("d", "bc", "k", "real_l", "cap"))
def _l1_topk_twolevel_jit(
    blocks_flat, lib_flat, *, d: int, bc: int, k: int, real_l: int, cap: int
):
    blocks = blocks_flat.reshape(-1, d)
    lib = lib_flat.reshape(-1, d)
    lp = lib.shape[0]  # padded to a multiple of _TL_SEG by the caller
    nseg = lp // _TL_SEG
    col = jnp.arange(lp, dtype=jnp.int32)
    invalid = col >= real_l
    seg_base = (jnp.arange(nseg, dtype=jnp.int32) * _TL_SEG)[None, :, None]
    # min-identity: |x-t| = x + t - 2*min(x,t), so
    # dist[b, l] = cx[b] + score[b, l] with score = ct[l] - 2*sum_min.
    # cx is a per-block constant: score ordering == distance ordering
    # (ties included), and the stripe drops one op per element.
    score_of = _stripe_score_env(lib, invalid)

    def per_chunk(xc):
        score = score_of(xc)
        seg = score.reshape(bc, nseg, _TL_SEG)
        nd1, ni1 = jax.lax.top_k(-seg, cap)  # [bc, nseg, cap]
        vals = -nd1  # ascending per segment; ties -> lowest column
        cols = ni1.astype(jnp.int32) + seg_base
        # global stage: one two-key (val, col) sort + slice. The sort's
        # tie order (equal vals -> ascending col) IS the production
        # contract, and it yields the selected columns directly — no
        # take_along_axis gather. Replaces top_k(-vals, k)+gather, whose
        # earliest-position tie rule gave the same order because stage-2
        # positions restricted to equal vals are ascending columns (the
        # same sort-based finish as _ad_rescore_jit). Tie order checked on
        # the H100 by chip_smoke.py.
        sv, sc = jax.lax.sort(
            (vals.reshape(bc, nseg * cap), cols.reshape(bc, nseg * cap)),
            dimension=1,
            num_keys=2,
        )
        sv, sc = sv[:, :k], sc[:, :k]
        cx = xc.astype(jnp.int32).sum(-1)  # [bc]
        out_d = jnp.where(sv >= _TL_BIG, I32_MAX, sv + cx[:, None])
        kth = sv[:, k - 1]
        ok = jnp.all(vals[:, :, cap - 1] > kth[:, None], axis=1)
        return out_d, sc, ok

    nb = blocks.shape[0] // bc
    dists, rows, ok = jax.lax.map(per_chunk, blocks.reshape(nb, bc, d))
    return dists.reshape(-1, k), rows.reshape(-1, k), ok.reshape(-1)


def l1_topk_twolevel(blocks, lib, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact k nearest rows per block — same contract and results as
    `l1_topk_stripes` (ascending (distance, row), lowest-row ties), via the
    segmented two-level top-k with per-row certification + stripe fallback.
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, d = blocks.shape
    l = lib.shape[0]
    lp = -(-l // _TL_SEG) * _TL_SEG
    nseg = lp // _TL_SEG
    kk = min(k, l)
    if kk > min(l, nseg * _TL_CAP) or b == 0:
        return l1_topk_stripes(blocks, lib, k)
    bc = min(_STRIPE_BC, max(8, 1 << (b - 1).bit_length()))
    bp = -(-b // bc) * bc
    blocks_p = np.pad(blocks, ((0, bp - b), (0, 0)))
    lib_p = np.pad(lib, ((0, lp - l), (0, 0)))
    dists, rows, ok = _l1_topk_twolevel_jit(
        jnp.asarray(blocks_p.reshape(-1)),
        jnp.asarray(lib_p.reshape(-1)),
        d=d,
        bc=bc,
        k=kk,
        real_l=l,
        cap=_TL_CAP,
    )
    out_d = np.asarray(jax.device_get(dists))[:b]
    out_r = np.asarray(jax.device_get(rows))[:b]
    bad = np.flatnonzero(~np.asarray(jax.device_get(ok))[:b])
    out_d, out_r = _stripe_fallback(out_d, out_r, bad, blocks, lib, kk)
    return _pad_topk(out_d, out_r, b, k, kk)


# ---------------------------------------------------------------------------
# Adaptive coarse-to-fine certified top-k (no-repeat scorer for real data)
#
# Real tile libraries are strongly clusterable: most library rows are far
# from any given block, and the true top-k distances are small. A coarse
# projection that sums groups of `g` adjacent coordinates yields an exact
# L1 LOWER bound (|sum x - sum t| <= sum |x - t| per group) at 1/g the
# work, so most of the library can be pruned before the full-D
# distance is ever computed:
#
#   1. coarse stripes with STRIDED segments (segment s holds columns
#      {s + k*nseg}; clustered libraries are contiguous runs in discovery
#      order, so striding spreads a run across min(len, nseg) segments —
#      no physical permutation, and survivor columns ARE original rows)
#      -> per-segment top_k(cap) survivors,
#   2. sort survivors, keep the m best as candidates; everything else
#      provably has coarse >= c_next = min(worst kept per segment, first
#      unselected survivor),
#   3. exact full-D rescore of the m candidates (an XLA row gather fused
#      with the abs-diff reduce) — sorted by (true distance, row) ->
#      top-k lists,
#   4. per-row certificate: c_next > k-th true distance means no pruned
#      row could enter the list (strict > also covers boundary ties);
#      uncertified rows are recomputed with the plain stripe kernel.
#
# On concentrated data (uniform-random inputs: every distance within a
# few % of the mean) no lossy projection can separate candidates; a
# cheap count check after step 1 detects that and reroutes to the
# direct two-level scorer, wasting only the coarse pass (~8%).
# ---------------------------------------------------------------------------

#: coarse group width preference (first divisor of nc from this list is
#: used). Wider groups make the coarse pass cheaper but the bound looser
#: (they cancel more texture); an uninformative bound costs a rerouted
#: run, not correctness. Not tuned on the H100.
_AD_GROUPS = (32, 16, 8, 4)
#: coarse survivors per 128-column segment (Poisson headroom: with ~1.5k
#: library rows whose coarse bound undercuts the k-th true distance,
#: lambda ~ 3 per segment and P[>=16] ~ 1e-7)
_AD_CAP = 16
#: candidates rescored at full D per block: the floor that still serves
#: k=512 (the kk > m//2 gate). Exactness never depends on m — uncertified
#: rows take the stripe fallback. Not tuned on the H100.
_AD_M = 1024
#: block-axis slice for the adaptive scorer: bounds the coarse survivor
#: arrays' device footprint at huge B (each slice holds
#: slice * nseg * cap * 8 bytes of survivors — 1.6 GB at a 200k-row
#: library) while keeping slices large enough to fill the device
_AD_B_SLICE = 16384
#: device budget for the coarse survivor lists (vals+cols, [slice,
#: nseg*cap] i32 each): past the 200k-row regime the slice length is
#: derived from this so survivors never outgrow the device as L does (a
#: fixed 16384-row slice would hold 16 GB of survivors at a 2M-row
#: library): 16384 rows at 200k, 4224 at 1M, 2048 at 2M.
_AD_SURV_BYTES = 2 << 30


def _ad_b_slice(nseg: int, cap: int, bc: int) -> int:
    """Block-axis slice length: `_AD_B_SLICE` capped by the survivor
    budget, floored to a (non-zero) multiple of bc."""
    rows = _AD_SURV_BYTES // (nseg * cap * 8)
    return max(bc, min(_AD_B_SLICE, rows // bc * bc))


def _ad_params(nseg: int, m: int = _AD_M, cap: int = _AD_CAP) -> tuple[int, int]:
    """Scale the adaptive scorer's (m, cap) to the library size.

    cap: beyond ~1024 segments the expected top-k survivors per segment
    drop below 0.5, so cap=8 keeps the certificate while halving the
    survivor lists (a memory requirement at megascale); smaller
    libraries keep the safer cap=16.

    m: the rescore must dig proportionally into the survivor pool. The
    count of library rows whose coarse bound undercuts the true k-th
    distance grows ~linearly with L, but a fixed m digs a fixed depth:
    at L=1M rows (nseg=7813) m=1024 certified only 19 of 4096 sampled
    blocks on clustered data, and m=4096 certified all of them.
    ceil(nseg/2048) gives factor 1 up to the 200k-row library (nseg=1563)
    and factor 4 at 1M rows. Exactness never depends on m — uncertified
    rows take the stripe fallback — so the scaling is purely about
    keeping the certification rate ~100% as L grows. Not tuned on the
    H100.
    """
    if nseg > 1024:
        cap = min(cap, 8)
    m *= max(1, -(-nseg // 2048))
    return m, cap


def _ad_project(x, d: int, g: int, chan: bool):
    """Group-sum projection (any disjoint grouping is a valid L1 lower
    bound). `chan=True` groups g cells per RGB channel — palette coords
    interleave channels (analysis.py layout), and real tile differences
    are dominated by per-channel shifts whose signs would cancel across
    mixed-channel groups.

    Computed as a bf16 matmul with a 0/1 selection matrix (one library
    pass, no [r, nc/g, g, 3] intermediate). The matmul is exact: u8 is
    exact in bf16, per-group sums (<= g*255 < 2^24) accumulate exactly in
    f32 in any order (checked on the H100 by chip_smoke.py).
    """
    i = jnp.arange(d, dtype=jnp.int32)
    if chan:
        dout = (d // (3 * g)) * 3
        o = (i // (3 * g)) * 3 + i % 3
    else:
        dout = d // g
        o = i // g
    sel = (o[:, None] == jnp.arange(dout, dtype=jnp.int32)[None, :]).astype(
        jnp.bfloat16
    )
    out = jax.lax.dot(
        x.astype(jnp.bfloat16), sel, preferred_element_type=jnp.float32
    )
    return out.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("d", "g", "chan"))
def _ad_proj_bank_jit(bf, *, d, g, chan):
    """Project one flat u8 library bank to its [rows, dout] i32 coarse
    palette, in 8 statically-sliced chunks.

    Chunking (vs one whole-bank `_ad_project`): the bf16 cast of a whole
    bank materializes bank_bytes*2 of transient device memory (6.1 GB at
    a 1M-row mode-32 library).
    Row-independent, so chunking is bit-equal; every bank's row count is
    a multiple of 128 (see `_lib_banks`), so 8 always divides it.

    STATIC slices + an `optimization_barrier` chain, NOT a
    `lax.map(dynamic_slice(i * chunk))` scan: an earlier compiler
    miscompiled the scan form at a 2-bank 2M-row geometry (every output
    chunk held the LAST iteration's projection), which the certificate
    could not see (see the self-audit below). Static slices lower to
    plain HLO slices (s64 constant offsets — also immune to the i32
    start-arithmetic overflow the scan form risked past 2^31 bytes), and
    the barrier chain forces the 8 projections to schedule sequentially
    so only one chunk's bf16 transient is live at a time.
    """
    rows = bf.size // d
    if rows % 8:
        # `_lib_banks` guarantees multiples of 128; a violating caller
        # must error here, not silently drop tail rows (the replaced
        # lax.map form failed loudly at its reshape — keep that property)
        raise ValueError(
            f"_ad_proj_bank_jit: bank of {rows} rows is not divisible by "
            "8; the 8-way chunking would silently truncate the library"
        )
    n8 = rows // 8
    parts = []
    prev = None
    for i in range(8):
        x = jax.lax.slice(bf, (i * n8 * d,), ((i + 1) * n8 * d,))
        if prev is not None:
            x, _ = jax.lax.optimization_barrier((x, prev))
        p = _ad_project(x.reshape(n8, d), d, g, chan)
        parts.append(p)
        prev = p
    return jnp.concatenate(parts, axis=0)


def _ad_coarse_jit(blocks_flat, lib_pad_flat, *, d, g, chan, bc, cap, real_l):
    """Step 1: coarse survivor lists over strided segments.

    Segment s in [0, nseg) holds library columns {s + k*nseg}: the
    distance stripe is reshaped [bc, w, nseg] (w = lp/nseg) and
    transposed so top_k runs per segment — survivor columns are original
    library rows (col = k*nseg + s), no permutation anywhere.

    Returns (vals [B, nseg*cap] coarse bounds ascending per segment,
    cols [B, nseg*cap] library rows, s_min [B] min over segments of the
    worst kept value — part of the non-candidate bound).

    Plain function (not itself a jit): the per-bank projection runs as
    its own jit per bank (`_ad_proj_bank_jit` — see its docstring for
    the scan-aliasing miscompile that forced the split) and the
    stripe+select runs in `_ad_coarse_core_jit`. Called inside an outer
    trace (parallel/sharded.py shard_map) everything inlines into the
    caller's program with the same static-slice structure.
    """
    banks = (
        lib_pad_flat
        if isinstance(lib_pad_flat, (tuple, list))
        else (lib_pad_flat,)
    )
    parts = [_ad_proj_bank_jit(bf, d=d, g=g, chan=chan) for bf in banks]
    cl = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
    del parts
    return _ad_coarse_core_jit(
        blocks_flat, cl, d=d, g=g, chan=chan, bc=bc, cap=cap, real_l=real_l
    )


@functools.partial(
    jax.jit, static_argnames=("d", "g", "chan", "bc", "cap", "real_l")
)
def _ad_coarse_core_jit(blocks_flat, cl, *, d, g, chan, bc, cap, real_l):
    """Stripe + per-segment select over an already-projected library
    `cl` [lp, dout] i32 (see `_ad_coarse_jit` for the split rationale)."""
    blocks = blocks_flat.reshape(-1, d)
    lp = cl.shape[0]
    nseg = lp // _TL_SEG
    w = lp // nseg

    # f32 abs-diff stripe over the projected values (exact: group sums
    # <= g*255 and row sums < 2^24) — the projected library is small.
    # Segment-major column permutation (position s*w + k holds original
    # row k*nseg + s): the stripe then comes out segment-major directly,
    # replacing a per-chunk [bc, w, nseg] -> [bc, nseg, w] relayout with
    # one tiny per-call gather (bit-equal).
    pos = jnp.arange(lp, dtype=jnp.int32)
    src_row = (pos % w) * nseg + pos // w
    clf = cl[src_row].astype(jnp.float32)
    invalid_p = src_row >= real_l
    seg_base = jnp.arange(nseg, dtype=jnp.int32)[None, :, None]

    def per_chunk(xc):
        cb = _ad_project(xc, d, g, chan).astype(jnp.float32)
        dist = jnp.abs(cb[:, None, :] - clf[None]).sum(-1, dtype=jnp.float32)
        # f32-keyed selection: the i32 cast moves AFTER top_k, so the sort
        # keys stay in the f32 domain (exact: projected row sums < 2^24
        # and _TL_BIG = 2^30 is a power of two; bit-equal incl. ties)
        dist = jnp.where(invalid_p[None, :], jnp.float32(_TL_BIG), dist)
        seg = dist.reshape(bc, nseg, w)  # already segment-major
        nd1, ni1 = jax.lax.top_k(-seg, cap)
        vals = (-nd1).astype(jnp.int32)  # [bc, nseg, cap]
        cols = ni1.astype(jnp.int32) * nseg + seg_base
        s_min = vals[:, :, cap - 1].min(axis=1)  # [bc]
        return vals.reshape(bc, nseg * cap), cols.reshape(bc, nseg * cap), s_min

    nb = blocks.shape[0] // bc
    vals, cols, s_min = jax.lax.map(per_chunk, blocks.reshape(nb, bc, d))
    s = vals.shape[-1]
    return vals.reshape(-1, s), cols.reshape(-1, s), s_min.reshape(-1)


#: per-buffer byte ceiling for the library banks the adaptive scorer
#: uploads: libraries above it are split into power-of-two-row banks,
#: each its own XLA buffer. The split began as a guard for a kernel's
#: 32-bit row offsets; the XLA scorers keep it because the coarse
#: projection (`_ad_proj_bank_jit`) and the audit slice per bank.
_DMA_LIB_BYTES_MAX = 1 << 32


def _dma_bank_rows(dp: int) -> int:
    """Rows per library bank: the largest power of two whose bank stays
    under `_DMA_LIB_BYTES_MAX` at row width dp."""
    rb = 1
    while rb * 2 * dp <= _DMA_LIB_BYTES_MAX:
        rb *= 2
    return rb


def _lib_banks(lib_pad: np.ndarray, d: int):
    """Upload a host [lp, d] u8 library as the flat device bank tuple the
    adaptive-scorer jits take: one bank when it fits `_DMA_LIB_BYTES_MAX`
    (byte-identical single buffer), else `_dma_bank_rows` power-of-two-row
    banks plus a smaller last bank. Callers pad lp to a multiple of 128
    (`_TL_SEG`), so every bank's row count is a multiple of 128 and the
    coarse projection's 8-way chunking divides it."""
    rb = _dma_bank_rows(d)
    lp = lib_pad.shape[0]
    if lp <= rb:
        return (jnp.asarray(np.ascontiguousarray(lib_pad).reshape(-1)),)
    return tuple(
        jnp.asarray(np.ascontiguousarray(lib_pad[i : i + rb]).reshape(-1))
        for i in range(0, lp, rb)
    )


@functools.partial(
    jax.jit, static_argnames=("d", "bc", "m", "k", "real_l")
)
def _ad_rescore_jit(
    blocks_flat, vals, cols, s_min, lib_pad_flat, *, d, bc, m, k, real_l
):
    """Steps 2-4: select m candidates, exact rescore (an XLA row gather
    of the candidates fused with the abs-diff reduce), certify.

    `lib_pad_flat` is a flat array or the `_lib_banks` tuple (see
    `_DMA_LIB_BYTES_MAX`); a banked library is concatenated for the
    gather."""
    blocks = blocks_flat.reshape(-1, d)
    banks = (
        lib_pad_flat
        if isinstance(lib_pad_flat, (tuple, list))
        else (lib_pad_flat,)
    )
    banks2 = tuple(bf.reshape(-1, d) for bf in banks)
    b = blocks.shape[0]
    nb = b // bc
    s = vals.shape[-1]

    def select(args):
        vc, cc, sm = args
        sv, sc = jax.lax.sort((vc, cc), dimension=1, num_keys=2)
        return sc[:, :m], jnp.minimum(sm, sv[:, m])

    cand, c_next = jax.lax.map(
        select,
        (vals.reshape(nb, bc, s), cols.reshape(nb, bc, s), s_min.reshape(nb, bc)),
    )
    cand = cand.reshape(b, m)  # original library rows (strided segments)
    c_next = c_next.reshape(b)

    libp = banks2[0] if len(banks2) == 1 else jnp.concatenate(banks2)

    def dist_chunk(args):
        xc, cc = args
        tc = libp[cc]  # [bc, m, D] row gather
        return jnp.abs(
            xc.astype(jnp.int32)[:, None, :] - tc.astype(jnp.int32)
        ).sum(-1, dtype=jnp.int32)

    dist = jax.lax.map(
        dist_chunk, (blocks.reshape(nb, bc, d), cand.reshape(nb, bc, m))
    ).reshape(b, m)
    dist = jnp.where(cand < real_l, dist, I32_MAX)

    def finish(args):
        dc, cc, cn = args
        sd, so = jax.lax.sort((dc, cc), dimension=1, num_keys=2)
        return sd[:, :k], so[:, :k], cn > sd[:, k - 1]

    dists, rows, ok = jax.lax.map(
        finish,
        (dist.reshape(nb, bc, m), cand.reshape(nb, bc, m), c_next.reshape(nb, bc)),
    )
    return dists.reshape(b, k), rows.reshape(b, k), ok.reshape(b)


def _run_block_slices(blocks_p, b_slice: int, kk: int, run_slice):
    """Drive `run_slice` over b_slice-row windows of blocks_p and
    assemble (dists, rows, ok) on the host. Shared by the single-device
    and mesh-sharded adaptive scorers so the slicing/assembly semantics
    stay structurally identical (a divisibility fix once had to be
    applied to two hand-kept copies)."""
    bp = blocks_p.shape[0]
    out_d = np.empty((bp, kk), np.int32)
    out_r = np.empty((bp, kk), np.int32)
    ok_all = np.empty(bp, bool)
    s0 = 0
    while s0 < bp:
        ln = min(b_slice, bp - s0)  # tail = one smaller compiled shape
        dists, rows, ok = run_slice(blocks_p[s0 : s0 + ln])
        out_d[s0 : s0 + ln] = np.asarray(jax.device_get(dists))
        out_r[s0 : s0 + ln] = np.asarray(jax.device_get(rows))
        ok_all[s0 : s0 + ln] = np.asarray(jax.device_get(ok))
        s0 += ln
    return out_d, out_r, ok_all


def _ad_plan(b: int, l: int, d: int, k: int, m: int = _AD_M, cap: int = _AD_CAP):
    """Shared adaptive-scorer eligibility + derived parameters, used by
    `l1_topk_adaptive`, the mesh-sharded scorer (parallel/sharded.py),
    and `_ad_prepare`'s prefetch decision. Returns
    (eligible, g, chan, kk, lp, nseg, m, cap); when `eligible` is False
    the caller routes to the two-level/stripe scorers."""
    # prefer grouping whole cells per channel (palette coords interleave
    # RGB; see _ad_project); fall back to consecutive coords otherwise
    chan = d % 3 == 0
    nc = d // 3 if chan else d
    g = next(
        (
            gg
            for gg in _AD_GROUPS
            if nc % gg == 0 and (nc // gg) * (3 if chan else 1) >= 4
        ),
        None,
    )
    kk = min(k, l)
    lp = -(-l // _TL_SEG) * _TL_SEG
    nseg = lp // _TL_SEG
    m, cap = _ad_params(nseg, m, cap)
    eligible = not (
        g is None
        or b == 0
        or kk > m // 2
        or m + 1 > nseg * cap
        or l <= 2 * m
        # at production scale and high D the device's route table may
        # hold the scorer to the direct two-level one
        or backend.topk_route(backend.platform(), d, b * l) == "twolevel"
    )
    return eligible, g, chan, kk, lp, nseg, m, cap


def _ad_prepare(lib, d: int, b: int | None = None, k: int | None = None):
    """Pad + upload a host library for `l1_topk_adaptive(prepared=...)`:
    exactly the `lib_pad` + `_lib_banks` steps the scorer performs
    internally, factored out so `l1_topk_streamed` can start the next
    bank's host->device transfer while the current bank scores (the
    transfer is the `jnp.asarray` inside `_lib_banks`; issuing it from a
    worker thread overlaps it with the main thread's blocked result
    pulls). Returns the opaque `(bank_tuple, rows)` handle.

    When the streamer supplies the query shape (`b`, `k`), ineligible
    banks — shapes `_ad_plan` would route to the two-level scorer, which
    uploads the library in its own form and ignores `prepared` — return
    None instead of paying a wasted upload (the scorer then uploads
    internally, serially, as before). The data-dependent adaptivity
    sample gate cannot be predicted here: concentrated data still
    spends one prefetched upload per bank before its two-level reroute."""
    lib = np.asarray(lib, dtype=np.uint8)
    l = lib.shape[0]
    if b is not None and k is not None and not _ad_plan(b, l, d, k)[0]:
        return None
    lp = -(-l // _TL_SEG) * _TL_SEG
    lib_pad = np.zeros((lp, d), np.uint8)
    lib_pad[:l] = lib
    return (_lib_banks(lib_pad, d), l)


def _check_ad_prepared(prepared, l: int, lp: int, d: int):
    """Shape-validate an `_ad_prepare` handle against THIS library (a
    mismatched handle would silently score wrong banks). Returns the
    bank tuple. Shared by the single-chip and mesh-sharded scorers."""
    banks_pre, rows_pre = prepared
    if rows_pre != l or sum(bk.size for bk in banks_pre) != lp * d:
        raise ValueError(
            f"prepared banks cover {rows_pre} rows x "
            f"{sum(bk.size for bk in banks_pre)} elements; this "
            f"library needs {l} rows x {lp * d}"
        )
    return banks_pre


# ---------------------------------------------------------------------------
# Certificate self-audit
#
# A past 2M-row failure's scariest property was not the miscompile (a
# lax.map projection aliasing all chunks to the last iteration) — it was
# that the adaptive scorer CERTIFIED the wrong results: the certificate
# arithmetic trusts the
# coarse stage's own outputs, so a stage-level corruption is invisible
# to it. The audit below closes that hole in production: after every
# certified adaptive run at large library geometry, a random sample of
# blocks is re-scored end-to-end through the INDEPENDENT stripe oracle
# (no projection, no shortlist — the same full-library reduction the
# uncertified-row fallback uses, chunked over the already-resident
# device banks) and compared bit-for-bit. Any mismatch turns a silent
# wrong answer into a loud stderr warning plus a full oracle re-score.
# Reference bar: the brute scorer that is never wrong
# (rendering.rs:307-321).
# ---------------------------------------------------------------------------

#: audit every certified adaptive run whose library has at least this
#: many rows (the failure class only ever fired at multi-bank
#: multi-GiB geometry; small libraries are covered by CI parity tests
#: and the two-level scorer). Override with EMOSAIC_AUDIT_ROWS; disable
#: with EMOSAIC_AUDIT=0; sample size via EMOSAIC_AUDIT_SAMPLE.
_AUDIT_MIN_ROWS = 1 << 19


def _fold_topk_host(best_d, best_r, cd, cr, kk: int, l: int):
    """Fold one candidate chunk into a host-side running top-kk under
    the packed int64 (distance, lowest-GLOBAL-row) lexicographic key —
    the one exact selection every scorer shares (l1_topk's matrix path,
    the streamed cross-bank merge, and the audit oracle must stay
    bit-identical to each other, so they all fold through here).
    Padding entries carry I32_MAX distances and always lose; callers
    re-zero their rows at the end. (best_d is None) starts the fold."""
    if best_d is None:
        return cd, cr
    cat_d = np.concatenate([best_d, cd], axis=1)
    cat_r = np.concatenate([best_r, cr], axis=1)
    key = cat_d.astype(np.int64) * (l + 1) + cat_r
    part = np.argpartition(key, kk - 1, axis=1)[:, :kk]
    order = np.argsort(np.take_along_axis(key, part, axis=1), axis=1)
    sel = np.take_along_axis(part, order, axis=1)
    return (
        np.take_along_axis(cat_d, sel, axis=1),
        np.take_along_axis(cat_r, sel, axis=1),
    )


@functools.partial(jax.jit, static_argnames=("rows", "d", "n"))
def _bank_rows_flat_jit(bank_flat, lo, *, rows, d, n):
    """n rows of a FLAT device bank starting at row `lo`, returned
    flat. The 2D view is an inside-jit reshape (layout metadata, no
    fresh HBM allocation — an EAGER bank reshape is a multi-GiB copy
    that doubles library residency, CLAUDE.md rule 10), and the slice
    start is in ROW space (flat element offsets overflow the i32
    slice-start argument past 2^31 elements)."""
    chunk = jax.lax.dynamic_slice(
        bank_flat.reshape(rows, d), (lo, 0), (n, d)
    )
    return chunk.reshape(n * d)


def _stripes_banked(blocks, banks, l: int, d: int, kk: int):
    """Exact top-kk per block over device-resident flat library banks
    (`_lib_banks` tuple), via the stripe oracle in bounded row chunks
    folded with the streamed scorer's exact (distance, lowest-row)
    merge. Independent of the adaptive coarse/rescore stages — this is
    the audit's ground truth, and the loud-fallback scorer when an
    audit fails (the direct two-level scorer cannot run at multi-GiB
    library geometry: its whole-library f32 stripe copy would exceed
    HBM, which is why the fallback chunks instead)."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    b = blocks.shape[0]
    bc = min(_STRIPE_BC, max(8, 1 << (b - 1).bit_length()))
    bp = -(-b // bc) * bc
    bf = jnp.asarray(np.pad(blocks, ((0, bp - b), (0, 0))).reshape(-1))
    # chunk rows so the stripe jit's one-time f32 library copy stays at
    # half the stripe budget — the resident banks live alongside it
    ch = max(
        _TL_SEG,
        (_STRIPE_F32_MAX_BYTES // 2) // (4 * d) // _TL_SEG * _TL_SEG,
    )
    best_d = best_r = None
    g0 = 0
    for bk in banks:
        rows_b = bk.size // d
        # Chunk-slice in ROW space through an inside-jit 2D view
        # (_bank_rows_flat_jit): a flat bank can exceed 2^31 ELEMENTS
        # (bank 0 at the 1048576-row x 3072 geometry is 3.2e9), so
        # element-offset slices `bk[lo*d:]` overflow the i32 slice-
        # start argument past row ~699k (an OverflowError). Row starts
        # never can (banks
        # are < 2^32 BYTES by _dma_bank_rows). Only ONE chunk's copy is
        # ever live — no eager bank reshape, no doubled residency.
        for lo in range(0, rows_b, ch):
            cl = min(ch, rows_b - lo)
            valid = min(cl, l - (g0 + lo))
            if valid <= 0:
                break
            kc = min(kk, cl)
            dd_, rr_ = _l1_topk_stripes_jit(
                bf,
                _bank_rows_flat_jit(bk, lo, rows=rows_b, d=d, n=cl),
                d=d,
                bc=bc,
                k=kc,
                real_l=valid,
            )
            cd = np.asarray(jax.device_get(dd_))[:b]
            cr = np.asarray(jax.device_get(rr_))[:b] + (g0 + lo)
            if kc < kk:  # chunk shorter than k: pad losers
                cd = np.concatenate(
                    [cd, np.full((b, kk - kc), I32_MAX, np.int32)], axis=1
                )
                cr = np.concatenate(
                    [cr, np.zeros((b, kk - kc), np.int32)], axis=1
                )
            best_d, best_r = _fold_topk_host(best_d, best_r, cd, cr, kk, l)
        g0 += rows_b
    best_r = np.where(best_d == I32_MAX, 0, best_r)
    return best_d, best_r


def _audit_would_run(l: int, b: int, kk: int) -> bool:
    """Whether `_ad_audit` will actually score at this geometry, under
    the same env knobs it reads, so a caller that reports audit coverage
    never counts a below-threshold SKIP as a passed audit."""
    if os.environ.get("EMOSAIC_AUDIT", "1") == "0":
        return False
    min_rows = int(os.environ.get("EMOSAIC_AUDIT_ROWS", str(_AUDIT_MIN_ROWS)))
    return l >= min_rows and b > 0 and kk > 0


def _ad_audit(out_d, out_r, blocks, banks, l: int, d: int, kk: int, *, label):
    """Post-hoc exactness audit of a certified adaptive result (module
    comment above). Returns (out_d, out_r) — unchanged when the sample
    matches the stripe oracle bit-for-bit, else the FULL oracle
    re-score of every block, after a loud stderr warning."""
    b = blocks.shape[0]
    if not _audit_would_run(l, b, kk):
        return out_d, out_r
    ns = min(b, max(1, int(os.environ.get("EMOSAIC_AUDIT_SAMPLE", "32"))))
    rng = np.random.default_rng(0xAD17 + 31 * b + l)
    idx = np.sort(rng.choice(b, size=ns, replace=False))
    ad, ar = _stripes_banked(blocks[idx], banks, l, d, kk)
    row_ok = (ad == out_d[idx]).all(axis=1) & (ar == out_r[idx]).all(axis=1)
    if row_ok.all():
        return out_d, out_r
    print(
        f"⚠️  EXACTNESS AUDIT FAILED ({label}): "
        f"{int((~row_ok).sum())}/{ns} sampled blocks disagree with the "
        f"independent stripe oracle at L={l} D={d} — the certificate "
        f"cannot be trusted for this run; re-scoring all {b} blocks "
        "through the oracle (exact, slower)",
        file=sys.stderr,
    )
    return _stripes_banked(blocks, banks, l, d, kk)


def l1_topk_adaptive(
    blocks,
    lib,
    k: int,
    *,
    m: int = _AD_M,
    cap: int = _AD_CAP,
    prepared=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact k nearest rows per block — same contract and results as
    `l1_topk_stripes` — via the adaptive coarse-to-fine certified scorer
    (module comment above). Falls back to `l1_topk_twolevel` wholesale
    when the coarse pass cannot prune (concentrated data), and per-row to
    the stripe kernel for uncertified rows.

    `prepared` is an `_ad_prepare(lib, d)` handle: the already-uploaded
    device bank tuple for THIS `lib`, used instead of re-uploading it
    (the streamed scorer's prefetch). The host `lib` is still required —
    the two-level/stripe fallback routes score it directly. Results are
    bit-identical with or without `prepared`.
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, d = blocks.shape
    l = lib.shape[0]
    if lib.size > _lib_budget() and l > _TL_SEG:
        # beyond the device-resident budget: stream host banks
        # (terminates — streamed banks are clamped under this gate, and
        # un-subdividable libraries of <= _TL_SEG rows stay direct)
        return l1_topk_streamed(blocks, lib, k)
    eligible, g, chan, kk, lp, nseg, m, cap = _ad_plan(
        b, l, d, k, m, cap
    )
    if not eligible:
        return l1_topk_twolevel(blocks, lib, k)
    if prepared is not None:
        _check_ad_prepared(prepared, l, lp, d)
    bc = min(_STRIPE_BC, max(8, 1 << (b - 1).bit_length()))
    # the coarse survivor lists ([slice, nseg*cap] i32 x2) are the only
    # arrays that scale with BOTH b and l: slice the block axis so their
    # HBM footprint stays bounded (a 200k-block x 200k-row run would
    # otherwise allocate ~20 GB of survivors). Padding stays minimal (to
    # bc, like the pre-slicing code); the tail becomes a second, smaller
    # compiled shape rather than a b_slice-padded slice full of zero rows
    # (which would score up to b_slice-bc phantom rows through the whole
    # pipeline).
    bp = -(-b // bc) * bc
    blocks_p = np.pad(blocks, ((0, bp - b), (0, 0)))
    b_slice = min(bp, _ad_b_slice(nseg, cap, bc))
    if prepared is not None:
        lf = prepared[0]
    else:
        lib_pad = np.zeros((lp, d), np.uint8)
        lib_pad[:l] = lib
        lf = _lib_banks(lib_pad, d)  # 1-tuple below the DMA limit
    bc2 = min(64, bc)  # divides bc and every slice length (multiples of bc)

    def run(flat_blocks):
        vals, cols, s_min = _ad_coarse_jit(
            flat_blocks, lf, d=d, g=g, chan=chan, bc=bc, cap=cap, real_l=l
        )
        return _ad_rescore_jit(
            flat_blocks, vals, cols, s_min, lf,
            d=d, bc=bc2, m=m, k=kk, real_l=l,
        )

    # adaptivity gate: run one sample chunk through the whole pipeline
    # (~1/128 of the work) and check its actual certification rate —
    # concentrated data (every distance within a few % of the mean)
    # cannot be pruned by any lossy projection and is detected here.
    if bp > bc:
        sample = jnp.asarray(blocks_p[:bc].reshape(-1))
        _, _, ok_s = run(sample)
        if np.asarray(jax.device_get(ok_s)).mean() < 0.5:
            return l1_topk_twolevel(blocks, lib, k)
    out_d, out_r, ok_all = _run_block_slices(
        blocks_p, b_slice, kk, lambda sl: run(jnp.asarray(sl.reshape(-1)))
    )
    out_d, out_r = out_d[:b], out_r[:b]
    bad = np.flatnonzero(~ok_all[:b])
    out_d, out_r = _stripe_fallback(out_d, out_r, bad, blocks, lib, kk)
    out_d, out_r = _ad_audit(
        out_d, out_r, blocks, lf, l, d, kk, label="l1_topk_adaptive"
    )
    return _pad_topk(out_d, out_r, b, k, kk)


#: the streamed scorer's prefetch protocol: scorers exposing `prepare`
#: get next-bank uploads issued from a worker thread (l1_topk_streamed)
l1_topk_adaptive.prepare = _ad_prepare


#: device-resident library budget for the certified scorers (u8 bytes of
#: the [L, D] library). None derives it from the device
#: (`backend.device_lib_bytes`: `EMOSAIC_DEVICE_LIB_BYTES`, else a stated
#: share of `memory_stats()["bytes_limit"]`); tests pin an int. Libraries
#: above it stream through `l1_topk_streamed`: host-resident banks scored
#: one at a time, folded with an exact merge.
_DEVICE_LIB_BYTES_MAX: int | None = None


def _lib_budget() -> int:
    if _DEVICE_LIB_BYTES_MAX is not None:
        return _DEVICE_LIB_BYTES_MAX
    return backend.device_lib_bytes()


def _stream_bank_rows(d: int) -> int:
    """Rows per streamed-scorer host bank: the `_dma_bank_rows` power of
    two — each uploaded bank then is one library bank (`_lib_banks`
    returns a 1-tuple: the single-buffer device path), sits below the
    device budget,
    and, being a power of two >= `_TL_SEG`, keeps the coarse
    projection's chunking divisible (recursion-free)."""
    return max(_TL_SEG, _dma_bank_rows(d))


def l1_topk_streamed(
    blocks, lib, k: int, *, bank_rows: int | None = None, scorer=None
) -> tuple[np.ndarray, np.ndarray]:
    """Exact k nearest rows per block — same contract and results as
    `l1_topk_stripes` (ascending (distance, row), lowest-row ties) — for
    host-resident libraries too large to keep on the device
    (`_DEVICE_LIB_BYTES_MAX`): each `bank_rows`-row host bank is scored
    with the certified adaptive scorer (exact after per-row fallback),
    and banks fold together with an exact lexicographic
    (distance, global row) merge on the host.

    Exactness: distances are bank-independent, so every global top-k
    member is inside its own bank's exact top-k; the union of per-bank
    lists therefore contains the global top-k, and the fold keeps the
    running k best under the same (distance, lowest-row) key the device
    kernels use, ties included.

    `scorer` overrides the per-bank exact scorer (default
    `l1_topk_adaptive`) — `parallel.sharded_l1_topk_adaptive` passes a
    mesh-sharded closure so bank streaming composes with block sharding.

    Bank prefetch: when the scorer exposes a `prepare(lib_slice, d, b,
    k) -> handle | None` attribute (the default does — `_ad_prepare`),
    the NEXT bank's host->device upload is issued from a worker thread
    while the current bank scores, and the handle is passed back via the
    scorer's `prepared=` kwarg (None = the scorer would reroute this
    bank to a handle-ignoring fallback; it uploads internally instead).
    So one bank-upload latency is paid up front and the rest hide under
    scoring (not measured on the H100). Two banks
    are then device-resident at once, so auto-sized banks halve to keep
    the total inside the device budget (`_lib_budget`). An
    explicit `bank_rows` skips that halving but is still clamped to the
    device budget (at most `_DEVICE_LIB_BYTES_MAX // d` rounded down to
    a `_TL_SEG` multiple, at least `_TL_SEG`) — an over-budget request
    would re-enter this path from the per-bank scorer and/or OOM the
    device — and when two explicit banks cannot both fit the
    budget, prefetch is disabled for the run (serial streaming) rather
    than holding 2x the envelope on device. Disable with
    EMOSAIC_STREAM_PREFETCH=0. Results are bit-identical either way.

    Complements `parallel.sharded_l1_topk_adaptive` (blocks sharded
    across a chip mesh): streaming raises the PER-chip library ceiling
    from HBM to host RAM at the cost of one bank upload per ~4 GiB.
    Reference analogue: none — the reference hard-caps libraries at
    32 767 tiles (tileset.rs:178-183, main.rs:791); this extends the
    no-cap design axis past device memory.
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    score = l1_topk_adaptive if scorer is None else scorer
    b, d = blocks.shape
    l = lib.shape[0]
    rb = _stream_bank_rows(d) if bank_rows is None else bank_rows
    # clamp banks under the device budget so the per-bank adaptive calls
    # never re-enter this path (the floor case — a budget below one
    # _TL_SEG-row bank — stays direct via the gate's `l > _TL_SEG` arm)
    rb = max(_TL_SEG, min(rb, _lib_budget() // d // _TL_SEG * _TL_SEG))
    if b == 0:
        # direct empty result: re-entering a scorer here would bounce off
        # the oversized-library gates straight back (mutual recursion)
        return (
            np.full((0, k), I32_MAX, np.int32),
            np.zeros((0, k), np.int32),
        )
    if l <= rb:
        return score(blocks, lib, k)
    prep = getattr(score, "prepare", None)
    prefetch = prep is not None and os.environ.get(
        "EMOSAIC_STREAM_PREFETCH", "1"
    ) != "0"
    if prefetch and bank_rows is None:
        # two banks resident at once: halve the auto bank so current +
        # prefetched stay inside the device budget
        rb = max(
            _TL_SEG,
            min(rb, _lib_budget() // 2 // d // _TL_SEG * _TL_SEG),
        )
    elif prefetch and 2 * rb * d > _lib_budget():
        # an explicit bank_rows is honored as given (no halving), so when
        # two such banks cannot both fit the budget, fall back to
        # serial streaming instead of holding 2x the budget on device
        # (bit-identical; only the upload overlap is lost). Loud: a
        # silently-lost overlap misleads perf measurements
        print(
            f"   stream prefetch disabled: two explicit {rb}-row banks "
            "exceed the device-resident budget; uploading serially",
            file=sys.stderr,
        )
        prefetch = False
    kk = min(k, l)
    offs = range(0, l, rb)

    def bank_results():
        if not prefetch:
            for off in offs:
                dd, rr = score(blocks, lib[off : off + rb], kk)
                yield off, dd, rr
            return
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
            # b/kk let prepare decline banks its scorer would reroute to
            # a handle-ignoring fallback (handle=None -> internal upload)
            fut = ex.submit(prep, lib[:rb], d, b, kk)
            for off in offs:
                handle = fut.result()
                if off + rb < l:
                    fut = ex.submit(
                        prep, lib[off + rb : off + 2 * rb], d, b, kk
                    )
                dd, rr = score(
                    blocks, lib[off : off + rb], kk, prepared=handle
                )
                yield off, dd, rr

    best_d = best_r = None
    for off, dd, rr in bank_results():
        rr = rr + off  # global rows (padding entries re-zeroed below)
        best_d, best_r = _fold_topk_host(best_d, best_r, dd, rr, kk, l)
    # entries short of k real rows keep the shared padding convention
    best_r = np.where(best_d == I32_MAX, 0, best_r)
    return _pad_topk(best_d, best_r, b, k, kk)
