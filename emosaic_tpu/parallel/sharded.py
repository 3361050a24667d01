"""Sharded matching + composition over a ("data", "model") mesh.

Multi-device scaling design (replaces nothing in the reference — it is
single-process; SURVEY.md section 2.6 maps rayon data parallelism to this):

- source blocks are sharded over "data" (independent argmin problems);
- the tile library is sharded over "model": each shard searches its slice
  and the per-shard (min, global-row) winners are combined with an
  all-gather followed by a lexicographic (distance, row) fold —
  an associative combine, so the result is bit-identical to the
  single-chip kernel including the lowest-row tie-break;
- padding rows (to make shapes divisible) are *copies of row/block 0*, so
  they can never win a tie against the original (higher global row index)
  and never corrupt results;
- the composite gather is sharded over "data" block-rows with the tile
  stack replicated.

`sharded_mosaic_step` is the full device pipeline — analysis -> library ->
match -> composite — under one jit, the multi-chip "training step"
equivalent used by __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from emosaic_tpu.ops.analysis import _analyse_batch_jit
from emosaic_tpu.parallel.distributed import fetch
from emosaic_tpu.ops.distance import I32_MAX, _pad_topk, _stripe_f32_ok


def _absdiff_stripe(bc, lib_w, f32: bool):
    """Per-shard |x-t| stripe, in f32 when the library copy fits (see
    ops.distance._STRIPE_F32_MAX_BYTES); exact either way (u8-valued
    operands, row sums < 2^24), so results are bit-identical."""
    if f32:
        return (
            jnp.abs(bc.astype(jnp.float32)[:, None, :] - lib_w[None])
            .sum(axis=-1, dtype=jnp.float32)
            .astype(jnp.int32)
        )
    return jnp.abs(bc.astype(jnp.int32)[:, None, :] - lib_w[None]).sum(
        axis=-1, dtype=jnp.int32
    )


def _pad_rows_with_first(x: jax.Array, multiple: int) -> jax.Array:
    """Pad axis 0 to a multiple by repeating row 0 (tie-safe padding)."""
    n = x.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return x
    reps = jnp.broadcast_to(x[:1], (target - n,) + x.shape[1:])
    return jnp.concatenate([x, reps], axis=0)


def _pad_prepare(multiple: int):
    """Streamed-scorer `prepare` for the library-sharding kernels: the
    same pad + upload they perform internally (an uncommitted device
    array; each kernel's jit in_shardings distribute it at dispatch), so
    `l1_topk_streamed`'s worker thread can overlap the next bank's
    transfer with the current bank's scoring. Handle: (padded_lib, rows).
    b/k are part of the prepare protocol (scorers with fallback routes
    decline ineligible banks by returning None) — these direct kernels
    consume every handle, so b/k are ignored here."""

    def prepare(lib_slice, d, b=None, k=None):
        lib_slice = np.asarray(lib_slice, dtype=np.uint8)
        return (
            _pad_rows_with_first(jnp.asarray(lib_slice), multiple),
            lib_slice.shape[0],
        )

    return prepare


def _check_pad_prepared(prepared, l: int, d: int, multiple: int):
    """Shape-validate a `_pad_prepare` handle against THIS library (a
    mismatched handle would silently score wrong banks)."""
    lib_p, rows = prepared
    target = -(-l // multiple) * multiple
    if rows != l or lib_p.shape != (target, d):
        raise ValueError(
            f"prepared library covers {rows} rows, shape "
            f"{tuple(lib_p.shape)}; this call needs {l} rows, shape "
            f"({target}, {d})"
        )
    return lib_p


def _argmin_bank_scorer(kernel, mesh: Mesh, multiple: int):
    """Shared stream-gate closure for the argmin kernels: adapts the
    (dist, row) pair to the streamer's top-k column shape and exposes
    the padded-upload `prepare` hook."""

    def bank_scorer(bb, ll, kx, prepared=None):
        d_, r_ = kernel(bb, ll, mesh, prepared=prepared)
        # fetch, not np.asarray: under multi-controller the sharded
        # outputs span non-addressable devices (distributed.fetch is a
        # plain device_get single-process)
        return fetch(d_)[:, None], fetch(r_)[:, None]

    bank_scorer.prepare = _pad_prepare(multiple)
    return bank_scorer


def _local_l1_argmin(blocks: jax.Array, lib: jax.Array):
    """Traceable dense L1 argmin (runs inside shard_map on each shard).

    Returns (dist [B] i32, local_row [B] i32), lowest-row tie-break.
    Chunked over blocks with lax.map to bound the [C, L, D] broadcast.
    """
    b, d = blocks.shape
    l = lib.shape[0]
    f32 = _stripe_f32_ok(lib.size)
    li = lib.astype(jnp.float32 if f32 else jnp.int32)
    chunk = max(1, min(b, (2**24) // max(1, l * d)))
    bp = -(-b // chunk) * chunk
    blocks_p = jnp.pad(blocks, ((0, bp - b), (0, 0)))

    def per_chunk(bc):
        dist = _absdiff_stripe(bc, li, f32)
        arg = jnp.argmin(dist, axis=1).astype(jnp.int32)
        return jnp.take_along_axis(dist, arg[:, None], axis=1)[:, 0], arg

    dists, rows = jax.lax.map(
        per_chunk, blocks_p.reshape(bp // chunk, chunk, d)
    )
    return dists.reshape(bp)[:b], rows.reshape(bp)[:b]


def _combine_over_model(dist, row):
    """All-gather per-shard winners over "model" and fold lexicographically
    (distance, then global row) — associative, exact tie-break."""
    dists_g = jax.lax.all_gather(dist, "model")  # [M, B]
    rows_g = jax.lax.all_gather(row, "model")
    best_d, best_r = dists_g[0], rows_g[0]
    for m in range(1, dists_g.shape[0]):
        d_m, r_m = dists_g[m], rows_g[m]
        take = (d_m < best_d) | ((d_m == best_d) & (r_m < best_r))
        best_d = jnp.where(take, d_m, best_d)
        best_r = jnp.where(take, r_m, best_r)
    return best_d, best_r



# ---------------------------------------------------------------------------
# jit factories: a per-call closure would retrace and recompile an
# identical program for EVERY streamed library bank. The lru_cache keys
# carry everything the closures capture; same mesh + shapes -> the cached
# PjitFunction.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _argmin_run_jit(mesh: Mesh, ls: int):
    @functools.partial(
        jax.jit,
        in_shardings=(
            NamedSharding(mesh, P("data", None)),
            NamedSharding(mesh, P("model", None)),
        ),
        out_shardings=NamedSharding(mesh, P("data")),
    )
    def run(blocks_s, lib_s):
        def body(bl, li):
            m = jax.lax.axis_index("model")
            dist, local_row = _local_l1_argmin(bl, li)
            grow = m * ls + local_row
            return _combine_over_model(dist, grow)

        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("data", None), P("model", None)),
            out_specs=P("data"),
            # outputs are value-replicated over "model" after the
            # all-gather fold, but that can't be statically inferred
            check_vma=False,
        )(blocks_s, lib_s)

    return run


@functools.lru_cache(maxsize=64)
def _argmin_ring_run_jit(ring: Mesh, ls: int, n: int):
    perm = tuple((i, (i + 1) % n) for i in range(n))  # shard i -> i+1

    @functools.partial(
        jax.jit,
        in_shardings=(
            NamedSharding(ring, P("ring", None)),
            NamedSharding(ring, P("ring", None)),
        ),
        out_shardings=NamedSharding(ring, P("ring")),
    )
    def run(blocks_s, lib_s):
        def body(bl, li):
            me = jax.lax.axis_index("ring")

            def hop(k, carry):
                best_d, best_r, slab = carry
                # slab originated on shard (me - k) mod n
                origin = (me - k) % n
                d, local_row = _local_l1_argmin(bl, slab)
                grow = origin * ls + local_row
                take = (d < best_d) | ((d == best_d) & (grow < best_r))
                best_d = jnp.where(take, d, best_d)
                best_r = jnp.where(take, grow, best_r)
                slab = jax.lax.ppermute(slab, "ring", perm)
                return best_d, best_r, slab

            nb = bl.shape[0]
            init = (
                jnp.full((nb,), I32_MAX, dtype=jnp.int32),
                jnp.zeros((nb,), dtype=jnp.int32),
                li,
            )
            best_d, best_r, _ = jax.lax.fori_loop(0, n, hop, init)
            return best_d, best_r

        return jax.shard_map(
            body,
            mesh=ring,
            in_specs=(P("ring", None), P("ring", None)),
            out_specs=P("ring"),
            check_vma=False,
        )(blocks_s, lib_s)

    return run


@functools.lru_cache(maxsize=64)
def _topk_run_jit(mesh: Mesh, ls: int, kk: int, real_l: int):
    @functools.partial(
        jax.jit,
        in_shardings=(
            NamedSharding(mesh, P("data", None)),
            NamedSharding(mesh, P("model", None)),
        ),
        out_shardings=(
            NamedSharding(mesh, P("data", None)),
            NamedSharding(mesh, P("data", None)),
        ),
    )
    def run(blocks_s, lib_s):
        def body(bl, li):
            m = jax.lax.axis_index("model")
            # per-shard k is capped by the shard size; the merged
            # M * k_loc >= kk candidates always contain the true top-kk
            # (if ls < kk then M*ls >= L >= kk)
            k_loc = min(kk, ls)
            d_loc, r_loc = _local_l1_topk(bl, li, k_loc, m * ls, real_l, ls)
            dg = jax.lax.all_gather(d_loc, "model")  # [M, Bs, kk]
            rg = jax.lax.all_gather(r_loc, "model")
            dc = jnp.moveaxis(dg, 0, 1).reshape(d_loc.shape[0], -1)
            rc = jnp.moveaxis(rg, 0, 1).reshape(d_loc.shape[0], -1)
            sd, sr = jax.lax.sort((dc, rc), dimension=1, num_keys=2)
            sd, sr = sd[:, :kk], sr[:, :kk]
            # padding convention of l1_topk: row 0 under I32_MAX distance
            sr = jnp.where(sd == I32_MAX, 0, sr)
            return sd, sr

        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("data", None), P("model", None)),
            out_specs=(P("data", None), P("data", None)),
            check_vma=False,
        )(blocks_s, lib_s)

    return run


@functools.lru_cache(maxsize=64)
def _adaptive_run_jit(
    mesh: Mesh, d: int, g: int, chan: bool, bc: int, cap: int,
    real_l: int, bc2: int, m: int, kk: int,
):
    from emosaic_tpu.ops import distance as dd

    spec_b = P(tuple(mesh.axis_names))  # block axis over every mesh axis

    @functools.partial(
        jax.jit,
        in_shardings=(
            NamedSharding(mesh, spec_b),
            NamedSharding(mesh, P(None)),
        ),
        out_shardings=(
            NamedSharding(mesh, spec_b),
            NamedSharding(mesh, spec_b),
            NamedSharding(mesh, spec_b),
        ),
    )
    def run(blocks_s, lf):
        def body(bl, lf_rep):
            bf = bl.reshape(-1)
            vals, cols, s_min = dd._ad_coarse_jit(
                bf, lf_rep, d=d, g=g, chan=chan, bc=bc, cap=cap, real_l=real_l
            )
            return dd._ad_rescore_jit(
                bf, vals, cols, s_min, lf_rep,
                d=d, bc=bc2, m=m, k=kk, real_l=real_l,
            )

        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(spec_b, P(None)),
            out_specs=(spec_b, spec_b, spec_b),
            check_vma=False,
        )(blocks_s, lf)

    return run


def sharded_l1_argmin(
    blocks, lib, mesh: Mesh, *, prepared=None
) -> tuple[np.ndarray, np.ndarray]:
    """Exact L1 nearest library row, sharded over a ("data", "model") mesh.

    Same contract (and bit-identical results) as ops.distance.l1_argmin.
    blocks: [B, D] uint8; lib: [L, D] uint8. Libraries whose per-"model"
    shard exceeds the device-resident budget stream host banks through
    this same kernel (numpy outputs on that route; `prepared` is the
    streamer's prefetched `_pad_prepare` handle for THIS lib).
    """
    from emosaic_tpu.ops import distance as dd

    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, l = blocks.shape[0], lib.shape[0]
    if lib.size // n_model > dd._lib_budget() and l > dd._TL_SEG:
        da, ra = dd.l1_topk_streamed(
            blocks,
            lib,
            1,
            scorer=_argmin_bank_scorer(sharded_l1_argmin, mesh, n_model),
        )
        return da[:, 0], ra[:, 0]
    blocks_p = _pad_rows_with_first(jnp.asarray(blocks, jnp.uint8), n_data)
    if prepared is not None:
        lib_p = _check_pad_prepared(prepared, l, blocks.shape[1], n_model)
    else:
        lib_p = _pad_rows_with_first(jnp.asarray(lib, jnp.uint8), n_model)
    ls = lib_p.shape[0] // n_model

    dist, row = _argmin_run_jit(mesh, ls)(blocks_p, lib_p)
    # padded lib rows are copies of row 0 with higher indices: they can
    # never be selected; padded blocks are sliced off here. fetch, not a
    # raw sharded return: production callers np.asarray these, which
    # raises under multi-controller
    return fetch(dist)[:b], fetch(row)[:b]


def sharded_l1_argmin_ring(
    blocks, lib, mesh: Mesh, *, prepared=None
) -> tuple[np.ndarray, np.ndarray]:
    """Exact L1 argmin with *ring rotation* of library shards (the
    sequence/context-parallel analogue called out in SURVEY §2.6: blocks
    stay resident per shard; library shards rotate around the ring via
    ppermute, each hop folding a partial (min, global-row) result).

    Communication per device is the library shard size x (n-1) hops over
    the interconnect — preferable to `sharded_l1_argmin`'s result all-gather when the
    block count dwarfs the library. Results are bit-identical to the
    single-chip kernel (lexicographic fold preserves the lowest-row
    tie-break regardless of hop order). Uses the flattened mesh (both axes)
    as one ring. Libraries whose per-ring shard exceeds the
    device-resident budget stream host banks through this same kernel
    (numpy outputs on that route).
    """
    from emosaic_tpu.ops import distance as dd

    devs = mesh.devices.reshape(-1)
    n = len(devs)
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    if lib.size // n > dd._lib_budget() and lib.shape[0] > dd._TL_SEG:
        da, ra = dd.l1_topk_streamed(
            blocks,
            lib,
            1,
            scorer=_argmin_bank_scorer(sharded_l1_argmin_ring, mesh, n),
        )
        return da[:, 0], ra[:, 0]
    ring = Mesh(devs, axis_names=("ring",))
    blocks_p = _pad_rows_with_first(jnp.asarray(blocks, jnp.uint8), n)
    if prepared is not None:
        lib_p = _check_pad_prepared(prepared, lib.shape[0], blocks.shape[1], n)
    else:
        lib_p = _pad_rows_with_first(jnp.asarray(lib, jnp.uint8), n)
    b, l = np.asarray(blocks).shape[0], np.asarray(lib).shape[0]
    ls = lib_p.shape[0] // n
    dist, row = _argmin_ring_run_jit(ring, ls, n)(blocks_p, lib_p)
    return fetch(dist)[:b], fetch(row)[:b]


def _local_l1_topk(blocks, lib, k: int, row_offset, real_l: int, ls: int):
    """Traceable per-shard stripe top-k with GLOBAL row ids.

    blocks [Bs, D], lib [ls, D] (this shard's slice; rows at global
    row_offset..row_offset+ls, padding past real_l masked out). Returns
    (dist [Bs, k], grow [Bs, k]) ascending by (distance, global row) —
    lax.top_k prefers lower indices on ties, which are lower global rows.
    """
    b, d = blocks.shape
    f32 = _stripe_f32_ok(lib.size)
    li = lib.astype(jnp.float32 if f32 else jnp.int32)
    col = jnp.arange(ls, dtype=jnp.int32)
    invalid = (row_offset + col) >= real_l
    chunk = max(1, min(b, (2**24) // max(1, ls)))
    bp = -(-b // chunk) * chunk
    blocks_p = jnp.pad(blocks, ((0, bp - b), (0, 0)))

    def per_chunk(bc):
        dist = _absdiff_stripe(bc, li, f32)
        dist = jnp.where(invalid[None, :], I32_MAX, dist)
        nd, ni = jax.lax.top_k(-dist, k)
        return -nd, row_offset + ni

    dists, rows = jax.lax.map(
        per_chunk, blocks_p.reshape(bp // chunk, chunk, d)
    )
    return dists.reshape(bp, k)[:b], rows.reshape(bp, k)[:b]


def sharded_l1_topk(
    blocks, lib, k: int, mesh: Mesh, *, prepared=None
) -> tuple[np.ndarray, np.ndarray]:
    """Exact k nearest rows per block over a ("data", "model") mesh.

    The multi-chip no-repeat scorer: blocks shard over "data" (pure DP),
    the library over "model"; per-shard top-k lists are all-gathered over
    and merged with a two-key (distance, row) sort — bit-identical to
    ops.distance.l1_topk_stripes including tie order and the
    I32_MAX/row-0 padding convention when k > L.
    """
    from emosaic_tpu.ops import distance as dd

    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]
    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, l = blocks.shape[0], lib.shape[0]
    if lib.size // n_model > dd._lib_budget() and l > dd._TL_SEG:
        # per-"model" shard exceeds the device-resident budget: stream
        # host banks through this same sharded kernel (no re-entry —
        # banks are clamped under the whole-device budget)
        def bank_scorer(bb, ll, kx, prepared=None):
            return sharded_l1_topk(bb, ll, kx, mesh, prepared=prepared)

        bank_scorer.prepare = _pad_prepare(n_model)
        return dd.l1_topk_streamed(blocks, lib, k, scorer=bank_scorer)
    kk = min(k, l)
    blocks_p = _pad_rows_with_first(jnp.asarray(blocks), n_data)
    if prepared is not None:
        lib_p = _check_pad_prepared(prepared, l, blocks.shape[1], n_model)
    else:
        lib_p = _pad_rows_with_first(jnp.asarray(lib), n_model)
    ls = lib_p.shape[0] // n_model

    dist, rows = _topk_run_jit(mesh, ls, kk, l)(blocks_p, lib_p)
    out_d = fetch(dist)[:b]
    out_r = fetch(rows)[:b]
    return _pad_topk(out_d, out_r, b, k, kk)


def sharded_l1_topk_adaptive(
    blocks, lib, k: int, mesh: Mesh, *, prepared=None
) -> tuple[np.ndarray, np.ndarray]:
    """Exact k nearest rows per block via the adaptive certified scorer,
    blocks sharded over EVERY mesh device (the scorer is block-parallel;
    the library replicates — coarse bounds need the full library).

    Bit-identical to ops.distance.l1_topk_adaptive (same kernels, same
    certificates; per-row results don't depend on which shard computes
    them; uncertified rows take the same single-device stripe fallback).
    Shapes the adaptive scorer declines — and concentrated data caught
    by its sample gate — route to `sharded_l1_topk` instead, so callers
    can use this unconditionally as the mesh no-repeat scorer.
    """
    from emosaic_tpu.ops import distance as dd

    blocks = np.asarray(blocks, dtype=np.uint8)
    lib = np.asarray(lib, dtype=np.uint8)
    b, d = blocks.shape
    l = lib.shape[0]
    if lib.size > dd._lib_budget() and l > dd._TL_SEG:
        # the library replicates per device, so past the device-resident
        # budget stream host banks — each bank scored by THIS sharded
        # scorer (bank streaming composes with block sharding; banks are
        # clamped under the budget so this gate never re-enters)
        def bank_scorer(bb, ll, kx, prepared=None):
            return sharded_l1_topk_adaptive(
                bb, ll, kx, mesh, prepared=prepared
            )

        # same zero-padded bank-tuple handle as the single-chip scorer:
        # the jit's P(None) in_sharding replicates it at dispatch
        bank_scorer.prepare = dd._ad_prepare
        return dd.l1_topk_streamed(blocks, lib, k, scorer=bank_scorer)
    # eligibility is the shared plan with l1_topk_adaptive — one gate,
    # no drift (it is also _ad_prepare's prefetch decision, so a
    # declined bank never receives a wasted handle)
    eligible, g, chan, kk, lp, nseg, m, cap = dd._ad_plan(
        b, l, d, k
    )
    if not eligible:
        return sharded_l1_topk(blocks, lib, k, mesh)
    if prepared is not None:
        dd._check_ad_prepared(prepared, l, lp, d)
    n_dev = mesh.size
    bc = dd._STRIPE_BC if b >= dd._STRIPE_BC * n_dev else 8
    unit = bc * n_dev  # every slice shards evenly into bc-row chunks
    bp = -(-b // unit) * unit
    blocks_p = np.pad(blocks, ((0, bp - b), (0, 0)))
    # per-DEVICE survivor memory is bounded exactly like the
    # single-device scorer's (the slicing exists to cap the
    # [rows, nseg*cap] coarse survivors; a 196k-block run on a 2-device
    # mesh would otherwise hold ~10 GB of survivors per device, and at
    # megascale libraries the budget shrinks the slice further — see
    # distance._ad_b_slice)
    b_slice = min(bp, dd._ad_b_slice(nseg, cap, bc) * n_dev)
    bc2 = min(64, bc)  # divides bc and every per-shard row count

    # sample gate (single device, one chunk): concentrated data cannot
    # be pruned by any lossy projection — reroute before paying the
    # sharded adaptive pass
    bf0 = jnp.asarray(blocks_p[:bc].reshape(-1))
    # bank tuple: 1-tuple below the DMA addressing limit; a replicated
    # megascale library splits into <4 GiB banks exactly like the
    # single-device scorer (distance._DMA_LIB_BYTES_MAX)
    if prepared is not None:
        lf_dev = prepared[0]
    else:
        lib_pad = np.zeros((lp, d), np.uint8)
        lib_pad[:l] = lib
        lf_dev = dd._lib_banks(lib_pad, d)
    v0, c0, s0 = dd._ad_coarse_jit(
        bf0, lf_dev, d=d, g=g, chan=chan, bc=bc, cap=cap, real_l=l
    )
    _, _, ok_s = dd._ad_rescore_jit(
        bf0, v0, c0, s0, lf_dev,
        d=d, bc=bc2, m=m, k=kk, real_l=l,
    )
    if np.asarray(jax.device_get(ok_s)).mean() < 0.5:
        return sharded_l1_topk(blocks, lib, k, mesh)

    run = _adaptive_run_jit(mesh, d, g, chan, bc, cap, l, bc2, m, kk)
    out_d, out_r, ok_all = dd._run_block_slices(
        blocks_p,
        b_slice,
        kk,
        # fetch each sharded slice result (multi-controller safe; plain
        # device_get pass-through single-process)
        lambda sl: tuple(fetch(o) for o in run(jnp.asarray(sl), lf_dev)),
    )
    out_d, out_r = out_d[:b], out_r[:b]
    bad = np.flatnonzero(~ok_all[:b])
    out_d, out_r = dd._stripe_fallback(out_d, out_r, bad, blocks, lib, kk)
    # certificate self-audit (ops.distance module comment): the sharded
    # scorer runs the same coarse/rescore stages, so the same
    # stage-corruption class applies — audit against the stripe oracle
    # on the replicated banks. Multi-controller runs audit on every
    # process (same deterministic sample; fetch() already made out_d/
    # out_r globally consistent, so all ranks take the same branch).
    out_d, out_r = dd._ad_audit(
        out_d, out_r, blocks, lf_dev, l, d, kk,
        label="sharded_l1_topk_adaptive",
    )
    return dd._pad_topk(out_d, out_r, b, k, kk)


def sharded_mosaic_step(
    tiles, source, mesh: Mesh, dim: int, tile_size: int
) -> np.ndarray:
    """Full device pipeline under one jit over the mesh: batched palette
    analysis (library sharded over "model") -> flip-augmented library with
    single-chip-consistent global row numbering -> sharded match (data x
    model) -> composite gather (sharded over "data" block-rows).

    Boundary arrays are 2D with the channels interleaved in the minor dim:
    tiles travel as [T, ts*ts*3], source as [H, W*3], the output as
    [H_out, W_out*3].

    Args:
      tiles: [T, ts, ts, 3] uint8 (T divisible by mesh "model" size).
      source: [H, W, 3] uint8 (H divisible by dim * data size).
    Returns the assembled mosaic [H/dim*ts, W/dim*ts, 3] uint8 (host numpy).
    """
    n_data = mesh.shape["data"]
    n_model = mesh.shape["model"]
    tiles = np.asarray(tiles, dtype=np.uint8)
    source = np.asarray(source, dtype=np.uint8)
    t, ts = tiles.shape[0], tiles.shape[1]
    h, w = source.shape[0], source.shape[1]
    nby, nbx = h // dim, w // dim
    if t % n_model:
        raise ValueError(f"T={t} not divisible by model={n_model}")
    if nby % n_data:
        raise ValueError(f"block rows {nby} not divisible by data={n_data}")
    ts_shard = t // n_model

    @functools.partial(
        jax.jit,
        in_shardings=(
            NamedSharding(mesh, P("model", None)),
            NamedSharding(mesh, P(None, None)),
        ),
        out_shardings=NamedSharding(mesh, P("data", None)),
    )
    def run(tiles2d_s, source2d_s):
        def body(tl2d, src2d):
            m = jax.lax.axis_index("model")
            dd = jax.lax.axis_index("data")
            tl = tl2d.reshape(ts_shard, ts, ts, 3)
            # --- analysis (model-sharded tile slice) ---
            pal = _analyse_batch_jit(tl, dim)  # [Ts, N, 3]
            flat = pal.reshape(ts_shard, -1)
            flipped = (
                pal.reshape(ts_shard, dim, dim, 3)[:, :, ::-1, :]
                .reshape(ts_shard, -1)
            )
            lib_local = jnp.concatenate([flat, flipped], axis=0)  # [2Ts, D]
            # --- blocks (data-sharded band of block-rows) ---
            hs = src2d.shape[0] // n_data  # replicated input: our band
            band = jax.lax.dynamic_slice_in_dim(src2d, dd * hs, hs, axis=0)
            x = band.reshape(hs // dim, dim, nbx, dim, 3)
            blocks = jnp.transpose(x, (0, 2, 1, 3, 4)).reshape(
                (hs // dim) * nbx, dim * dim * 3
            )
            # --- local match + global row mapping ---
            dist, local_row = _local_l1_argmin(blocks, lib_local)
            # single-chip lib layout: rows [0,T) unflipped then [T,2T)
            # flipped (ops.distance.build_library); shard m holds
            # unflipped [m*Ts,(m+1)*Ts) and flipped [T+m*Ts, ...)
            grow = jnp.where(
                local_row < ts_shard,
                m * ts_shard + local_row,
                t + m * ts_shard + (local_row - ts_shard),
            )
            _, row = _combine_over_model(dist, grow)
            # --- composite (gather from the flip-augmented full stack) ---
            stack2d = jax.lax.all_gather(tl2d, "model", tiled=True)  # [T, S]
            flip2d = (
                stack2d.reshape(t, ts, ts, 3)[:, :, ::-1, :].reshape(t, -1)
            )
            aug = jnp.concatenate([stack2d, flip2d], axis=0)  # [2T, S]
            sel = aug[row]  # [Bs, S]
            bby = hs // dim
            out = sel.reshape(bby, nbx, ts, ts * 3)
            return jnp.transpose(out, (0, 2, 1, 3)).reshape(
                bby * ts, nbx * ts * 3
            )

        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("model", None), P(None, None)),
            out_specs=P("data", None),
            check_vma=False,
        )(tiles2d_s, source2d_s)

    out2d = run(
        jnp.asarray(tiles.reshape(t, -1)),
        jnp.asarray(source.reshape(h, w * 3)),
    )
    return fetch(out2d).reshape(nby * ts, nbx * ts, 3)
