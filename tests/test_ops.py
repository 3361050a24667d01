"""Unit tests for the device kernels (analysis, distance, LUT, composite).

Mirrors the reference's inline unit suites: analysis.rs:38-73,
color.rs:44-101, tile.rs:122-141, plus new oracle checks for the matching
kernels (no equivalent exists in the reference — the kd-tree is a crate).
"""

import numpy as np
import pytest

from emosaic_tpu.ops import (
    analyse_batch,
    build_library,
    compose_mosaic,
    build_l1_lut,
    l1_argmin,
    l1_argmin_xla,
    l1_topk,
    lut_match,
    source_blocks,
    tint_blend,
)
from emosaic_tpu.ops.analysis import analyse_one
from emosaic_tpu.ops.distance import (
    flip_palettes,
    items_to_rows,
    rows_to_items,
)


def np_l1_all(blocks, lib):
    return np.abs(
        blocks.astype(np.int64)[:, None, :] - lib.astype(np.int64)[None, :, :]
    ).sum(-1)


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


def test_analyse_single_color():
    # analysis.rs:43-55 test_analyse_single_color
    img = np.full((2, 2, 3), [255, 0, 0], dtype=np.uint8)
    colors = analyse_one(img, dim=2)
    assert colors.shape == (4, 3)
    assert (colors == [255, 0, 0]).all()


def test_analyse_truncating_mean():
    # color.rs:49-63: mean of 100,200,50,150 = 125; and truncation semantics
    img = np.array(
        [[[100, 150, 200], [200, 100, 50]], [[50, 200, 100], [150, 50, 150]]],
        dtype=np.uint8,
    )
    colors = analyse_one(img, dim=1)
    assert (colors[0] == [125, 125, 125]).all()
    # truncation: (1+2)/2 = 1 (not 2)
    img2 = np.array([[[1, 1, 1], [2, 2, 2]]], dtype=np.uint8).reshape(1, 2, 3)
    assert (analyse_one(img2, dim=1)[0] == [1, 1, 1]).all()


def test_analyse_drops_trailing_pixels():
    # analysis.rs:6-8: box size floor(w/dim); trailing pixels outside
    # dim*floor(w/dim) are never read.
    img = np.zeros((5, 5, 3), dtype=np.uint8)
    img[:, 4, :] = 255  # only in the dropped trailing column
    img[4, :, :] = 255
    colors = analyse_one(img, dim=2)
    assert (colors == 0).all()


def test_analyse_batch_matches_one(rng):
    tiles = rng.integers(0, 256, size=(7, 8, 8, 3), dtype=np.uint8)
    batch = np.asarray(analyse_batch(tiles, dim=2))
    for i in range(7):
        assert (batch[i] == analyse_one(tiles[i], dim=2)).all()


def test_source_blocks_order():
    # analysis.rs:57-72 test_get_img_colors: row-major pixels within block
    img = np.zeros((4, 4, 3), dtype=np.uint8)
    for y in range(4):
        for x in range(4):
            img[y, x] = [x * 64, y * 64, 128]
    blocks = np.asarray(source_blocks(img, dim=2)).reshape(4, 4, 3)
    # block 0 covers (x,y) in [0,2)x[0,2): pixels (0,0),(1,0),(0,1),(1,1)
    assert (blocks[0][0] == [0, 0, 128]).all()
    assert (blocks[0][1] == [64, 0, 128]).all()
    assert (blocks[0][2] == [0, 64, 128]).all()
    assert (blocks[0][3] == [64, 64, 128]).all()
    # blocks are y-major: block 1 is (x,y) in [2,4)x[0,2)
    assert (blocks[1][0] == [128, 0, 128]).all()


# ---------------------------------------------------------------------------
# library / flips
# ---------------------------------------------------------------------------


def test_flip_palettes_involution(rng):
    # utils.rs:302-308 test_flipped_coords
    pal = rng.integers(0, 256, size=(5, 9, 3), dtype=np.uint8)
    flipped = np.asarray(flip_palettes(pal))
    assert (np.asarray(flip_palettes(flipped)) == pal).all()
    # N=4 explicit expectation: [p0 p1 / p2 p3] -> [p1 p0 / p3 p2]
    pal4 = np.arange(4 * 3, dtype=np.uint8).reshape(1, 4, 3)
    f = np.asarray(flip_palettes(pal4))
    assert (f[0, 0] == pal4[0, 1]).all()
    assert (f[0, 1] == pal4[0, 0]).all()
    assert (f[0, 2] == pal4[0, 3]).all()
    assert (f[0, 3] == pal4[0, 2]).all()


def test_item_row_mapping():
    rows = np.arange(10)
    items = np.asarray(rows_to_items(rows, 5))
    assert (items == [1, 2, 3, 4, 5, -1, -2, -3, -4, -5]).all()
    assert (np.asarray(items_to_rows(items, 5)) == rows).all()


# ---------------------------------------------------------------------------
# distance kernels vs numpy oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_cells", [1, 4, 9])
def test_l1_argmin_xla_oracle(rng, n_cells):
    pal = rng.integers(0, 256, size=(37, n_cells, 3), dtype=np.uint8)
    lib = np.asarray(build_library(pal))
    blocks = rng.integers(0, 256, size=(53, n_cells * 3), dtype=np.uint8)
    dist, row = l1_argmin_xla(blocks, lib)
    full = np_l1_all(blocks, lib)
    assert (np.asarray(dist) == full.min(1)).all()
    assert (np.asarray(row) == full.argmin(1)).all()  # lowest-row tie-break


def test_l1_argmin_pallas_fallback_matches(rng):
    # On CPU this exercises the dispatch path (falls back to XLA).
    pal = rng.integers(0, 256, size=(10, 1, 3), dtype=np.uint8)
    lib = np.asarray(build_library(pal))
    blocks = rng.integers(0, 256, size=(17, 3), dtype=np.uint8)
    d1, r1 = l1_argmin(blocks, lib)
    d2, r2 = l1_argmin_xla(blocks, lib)
    assert (np.asarray(d1) == np.asarray(d2)).all()
    assert (np.asarray(r1) == np.asarray(r2)).all()


def test_l1_topk_oracle(rng):
    pal = rng.integers(0, 256, size=(30, 4, 3), dtype=np.uint8)
    lib = np.asarray(build_library(pal))
    blocks = rng.integers(0, 256, size=(11, 12), dtype=np.uint8)
    k = 7
    dists, rows = l1_topk(blocks, lib, k)
    dists, rows = np.asarray(dists), np.asarray(rows)
    full = np_l1_all(blocks, lib)
    expect = np.sort(full, axis=1)[:, :k]
    assert (dists == expect).all()
    # rows actually achieve the distances
    got = np.take_along_axis(full, rows, axis=1)
    assert (got == dists).all()


def test_l1_topk_k_larger_than_library(rng):
    pal = rng.integers(0, 256, size=(3, 1, 3), dtype=np.uint8)
    lib = np.asarray(build_library(pal))  # 6 rows
    blocks = rng.integers(0, 256, size=(4, 3), dtype=np.uint8)
    dists, rows = l1_topk(blocks, lib, 10)
    assert np.asarray(dists).shape == (4, 10)
    assert (np.asarray(dists)[:, 6:] == np.int32(2**31 - 1)).all()


# ---------------------------------------------------------------------------
# LUT vs brute force
# ---------------------------------------------------------------------------


def test_lut_matches_brute(rng):
    pal = rng.integers(0, 256, size=(41, 1, 3), dtype=np.uint8)
    lib = np.asarray(build_library(pal))
    lut = build_l1_lut(lib)
    blocks = rng.integers(0, 256, size=(200, 3), dtype=np.uint8)
    d_lut, r_lut = lut_match(blocks, lut)
    full = np_l1_all(blocks, lib)
    assert (np.asarray(d_lut) == full.min(1)).all()
    assert (np.asarray(r_lut) == full.argmin(1)).all()


def test_lut_extreme_colors():
    # a single far-away tile: distance from opposite corner is 765
    lib = np.array([[0, 0, 0]], dtype=np.uint8)
    lut = build_l1_lut(lib)
    d, r = lut_match(np.array([[255, 255, 255]], dtype=np.uint8), lut)
    assert int(d[0]) == 765
    assert int(r[0]) == 0


def test_lut_duplicate_color_lowest_row():
    lib = np.array([[10, 10, 10], [10, 10, 10], [10, 10, 10]], dtype=np.uint8)
    lut = build_l1_lut(lib)
    _, r = lut_match(np.array([[10, 10, 10], [200, 3, 90]], dtype=np.uint8), lut)
    assert (np.asarray(r) == 0).all()


def test_lut_build_cached_per_content(rng, monkeypatch):
    # resident servers re-match the same library every request: the build
    # must be a cache hit (same device buffer), keyed by content not id
    from emosaic_tpu.ops import lut as lut_mod

    monkeypatch.setattr(lut_mod, "_LUT_CACHE", {})
    lib = rng.integers(0, 256, size=(37, 3), dtype=np.uint8)
    a = build_l1_lut(lib)
    b = build_l1_lut(lib.copy())  # different ndarray, same bytes
    assert a is b
    other = build_l1_lut(lib[:20])  # different content -> fresh build
    assert other is not a
    # capped: inserting beyond _LUT_CACHE_MAX evicts the oldest
    monkeypatch.setattr(lut_mod, "_LUT_CACHE_MAX", 1)
    build_l1_lut(lib[:10])
    assert len(lut_mod._LUT_CACHE) == 1
    # EMOSAIC_LUT_CACHE=0 bypasses both lookup and insertion
    monkeypatch.setattr(lut_mod, "_LUT_CACHE", {})
    monkeypatch.setenv("EMOSAIC_LUT_CACHE", "0")
    c = build_l1_lut(lib)
    assert c is not a and len(lut_mod._LUT_CACHE) == 0
    # cached results stay correct (the hit path returns the right table)
    monkeypatch.delenv("EMOSAIC_LUT_CACHE")
    blocks = rng.integers(0, 256, size=(64, 3), dtype=np.uint8)
    d1, r1 = lut_match(blocks, build_l1_lut(lib))
    d2, r2 = lut_match(blocks, build_l1_lut(lib))
    assert (np.asarray(d1) == np.asarray(d2)).all()
    assert (np.asarray(r1) == np.asarray(r2)).all()


# ---------------------------------------------------------------------------
# composite
# ---------------------------------------------------------------------------


def test_compose_mosaic_layout(rng):
    ts = 4
    stack = rng.integers(0, 256, size=(3, ts, ts, 3), dtype=np.uint8)
    items = np.array([[1, 2], [3, -1]], dtype=np.int32)
    out = np.asarray(compose_mosaic(items, stack))
    assert out.shape == (2 * ts, 2 * ts, 3)
    assert (out[:ts, :ts] == stack[0]).all()
    assert (out[:ts, ts:] == stack[1]).all()
    assert (out[ts:, :ts] == stack[2]).all()
    assert (out[ts:, ts:] == stack[0][:, ::-1, :]).all()  # flipped


def test_compose_bands_match_full(rng):
    from emosaic_tpu.ops.composite import iter_bands

    ts = 4
    stack = rng.integers(0, 256, size=(5, ts, ts, 3), dtype=np.uint8)
    items = rng.integers(1, 6, size=(6, 3)).astype(np.int32)
    items[1, 2] = -2
    full = np.asarray(compose_mosaic(items, stack))
    got = np.concatenate(list(iter_bands(items, stack, band_rows=2)), axis=0)
    assert (got == full).all()


def test_tint_blend():
    mosaic = np.zeros((4, 4, 3), dtype=np.uint8)
    src = np.full((2, 2, 3), 200, dtype=np.uint8)
    out = np.asarray(tint_blend(mosaic, src, 0.5))
    # alpha = floor(255*0.5) = 127 -> 200*127/255 = 99.6, and the
    # reference's NumCast f32->u8 cast TRUNCATES (main.rs:447-478 +
    # image-0.25.2 color.rs) -> 99, not round-to-nearest's 100
    assert (out == 99).all()
    # zero opacity is a no-op
    assert (np.asarray(tint_blend(mosaic, src, 0.0)) == mosaic).all()


def test_tint_blend_bit_exact_exhaustive():
    """Device tint == scalar port of the reference blend, for ALL
    256 alphas x 65536 (mosaic, source) channel pairs (VERDICT r2 #5)."""
    from emosaic_tpu.ops.composite import ref_tint_blend_u8, tint_blend

    m = np.broadcast_to(
        np.arange(256, dtype=np.uint8)[:, None, None], (256, 256, 3)
    )
    s = np.broadcast_to(
        np.arange(256, dtype=np.uint8)[None, :, None], (256, 256, 3)
    )
    for alpha in range(256):
        ref = ref_tint_blend_u8(m, s, alpha)
        # floor(255 * (alpha+0.5)/255) == alpha exactly, avoiding f64
        # round-down for opacities that should map to integer alpha
        got = np.asarray(tint_blend(m, s, (alpha + 0.5) / 255.0))
        if alpha == 0:
            ref = m  # tint_blend's alpha<=0 early return (identity; also
            # check the oracle agrees, making the early return pure perf)
            assert (ref_tint_blend_u8(m, s, 0) == m).all()
        assert (got == ref).all(), f"alpha={alpha}: {(got != ref).sum()} diffs"


# ---------------------------------------------------------------------------
# L2 fast mode (performance addition; reference is L1-only)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_cells", [1, 4])
def test_l2_argmin_oracle(rng, n_cells):
    from emosaic_tpu.ops.distance import l2_argmin

    pal = rng.integers(0, 256, size=(60, n_cells, 3), dtype=np.uint8)
    lib = np.asarray(build_library(pal))
    blocks = rng.integers(0, 256, size=(33, n_cells * 3), dtype=np.uint8)
    dist, row = l2_argmin(blocks, lib)
    full = (
        (blocks.astype(np.int64)[:, None, :] - lib.astype(np.int64)[None, :, :])
        ** 2
    ).sum(-1)
    # distances exact for the chosen row; argmin optimal
    got = np.take_along_axis(full, np.asarray(row)[:, None].astype(np.int64), 1)[:, 0]
    assert (np.asarray(dist) == got).all()
    assert (got == full.min(1)).all()


def test_compose_host_row_chunking(rng):
    # one-block-row bands, concatenated, equal the whole-mosaic compose
    from emosaic_tpu.ops import composite as comp

    ts = 4
    stack = rng.integers(0, 256, size=(5, ts, ts, 3), dtype=np.uint8)
    items = rng.integers(1, 6, size=(6, 3)).astype(np.int32)
    items[2, 1] = -4
    items[3, 0] = 0
    chunked = np.concatenate(list(comp.iter_bands(items, stack, band_rows=1)))
    full = comp.compose_mosaic(items, stack)
    assert (chunked == full).all()
    assert (chunked[3 * ts : 4 * ts, :ts] == 0).all()  # item 0 -> black


def test_l1_topk_above_budget_matches_matrix(rng, monkeypatch):
    # force the above-budget route (adaptive/two-level dispatch) and check
    # it against the dense matrix path
    from emosaic_tpu.ops import distance as dist_mod

    pal = rng.integers(0, 256, size=(30, 4, 3), dtype=np.uint8)
    lib = np.asarray(build_library(pal))
    blocks = rng.integers(0, 256, size=(11, 12), dtype=np.uint8)
    d_m, r_m = l1_topk(blocks, lib, 7)
    monkeypatch.setattr(dist_mod, "_TOPK_MATRIX_BUDGET", 0)
    d_s, r_s = l1_topk(blocks, lib, 7)
    assert (np.asarray(d_s) == d_m).all()
    got_m = np.take_along_axis(np_l1_all(blocks, lib), r_m.astype(np.int64), 1)
    got_s = np.take_along_axis(np_l1_all(blocks, lib), np.asarray(r_s).astype(np.int64), 1)
    assert (got_m == got_s).all()


def test_l1_topk_block_chunked_matches(rng, monkeypatch):
    from emosaic_tpu.ops import distance as dist_mod

    pal = rng.integers(0, 256, size=(30, 4, 3), dtype=np.uint8)
    lib = np.asarray(build_library(pal))
    blocks = rng.integers(0, 256, size=(200, 12), dtype=np.uint8)
    d1, r1 = l1_topk(blocks, lib, 5)
    # tiny budget -> many 64-row chunks, same results
    monkeypatch.setattr(dist_mod, "_TOPK_MATRIX_BUDGET", 64 * lib.shape[0])
    d2, r2 = l1_topk(blocks, lib, 5)
    assert (np.asarray(d1) == np.asarray(d2)).all()
    assert (np.asarray(r1) == np.asarray(r2)).all()


def test_l1_topk_stripes_matches_matrix_path(rng):
    # the fused-stripe scorer (no-repeat flagship path) must match the
    # dense-matrix oracle including (distance, row) tie ordering
    from emosaic_tpu.ops.distance import l1_topk_stripes

    pal = rng.integers(0, 256, size=(40, 4, 3), dtype=np.uint8)
    lib = np.array(build_library(pal))  # writable copy
    lib[33] = lib[5]  # forced exact tie
    blocks = rng.integers(0, 256, size=(97, 12), dtype=np.uint8)
    blocks[3] = lib[5]
    d_m, r_m = l1_topk(blocks, lib, 9)
    d_s, r_s = l1_topk_stripes(blocks, lib, 9)
    assert (d_s == np.asarray(d_m)).all()
    assert (r_s == np.asarray(r_m)).all()


def test_l1_topk_stripes_k_exceeds_library(rng):
    from emosaic_tpu.ops.distance import I32_MAX, l1_topk_stripes

    lib = rng.integers(0, 256, size=(5, 3), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(4, 3), dtype=np.uint8)
    d, r = l1_topk_stripes(blocks, lib, 8)
    assert d.shape == (4, 8)
    assert (d[:, 5:] == I32_MAX).all()


def test_l1_topk_dispatches_to_stripes_past_budget(rng, monkeypatch):
    from emosaic_tpu.ops import distance as dist_mod

    pal = rng.integers(0, 256, size=(30, 4, 3), dtype=np.uint8)
    lib = np.asarray(build_library(pal))
    blocks = rng.integers(0, 256, size=(200, 12), dtype=np.uint8)
    d1, r1 = l1_topk(blocks, lib, 5)
    monkeypatch.setattr(dist_mod, "_TOPK_MATRIX_BUDGET", 0)
    d2, r2 = l1_topk(blocks, lib, 5)  # now the stripe path
    assert (np.asarray(d1) == np.asarray(d2)).all()
    assert (np.asarray(r1) == np.asarray(r2)).all()


def test_l1_hybrid_exact_on_small_library(rng):
    # below the prefilter threshold the hybrid falls back to exact stripes
    from emosaic_tpu.ops.distance import l1_topk_hybrid

    pal = rng.integers(0, 256, size=(20, 4, 3), dtype=np.uint8)
    lib = np.asarray(build_library(pal))
    blocks = rng.integers(0, 256, size=(50, 12), dtype=np.uint8)
    d_h, r_h = l1_topk_hybrid(blocks, lib, 5)
    d_m, r_m = l1_topk(blocks, lib, 5)
    assert (d_h == np.asarray(d_m)).all()
    assert (r_h == np.asarray(r_m)).all()


def test_l1_hybrid_rescore_distances_are_exact_l1(rng):
    # large-enough library to engage the matmul prefilter: returned rows may
    # be approximate, but their distances must be the exact int32 L1
    from emosaic_tpu.ops.distance import l1_argmin_hybrid

    lib = rng.integers(0, 256, size=(600, 27), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(40, 27), dtype=np.uint8)
    d_h, r_h = l1_argmin_hybrid(blocks, lib)
    expect = np.abs(
        blocks.astype(np.int64)[:, None, :] - lib.astype(np.int64)[None]
    ).sum(-1)
    got = np.take_along_axis(expect, np.asarray(r_h)[:, None].astype(np.int64), 1)[:, 0]
    assert (np.asarray(d_h) == got).all()
    # exact-L2 prefilter at k_pre=64 over 600 rows: selections should in
    # fact be exact on this scale (CPU approx_min_k is exact)
    brute = expect.argmin(axis=1)
    assert (np.asarray(r_h) == brute).mean() > 0.9


def test_l1_topk_twolevel_matches_stripes(rng):
    # certified rows come straight from the segmented kernel; results must
    # equal the stripe oracle bit-for-bit including (distance, row) ties
    from emosaic_tpu.ops.distance import l1_topk_stripes, l1_topk_twolevel

    pal = rng.integers(0, 256, size=(150, 4, 3), dtype=np.uint8)
    lib = np.array(build_library(pal))
    lib[200] = lib[7]  # cross-segment exact tie
    blocks = rng.integers(0, 256, size=(70, 12), dtype=np.uint8)
    blocks[5] = lib[7]
    d_o, r_o = l1_topk_stripes(blocks, lib, 11)
    d_t, r_t = l1_topk_twolevel(blocks, lib, 11)
    assert (d_t == d_o).all()
    assert (r_t == r_o).all()


def test_l1_topk_twolevel_tie_storm_falls_back_exactly(rng):
    # every library row identical -> every distance ties -> no row can
    # certify (the k-th value equals every segment's cap-th value), so the
    # fallback must fire and the result must still be exact: rows 0..k-1
    from emosaic_tpu.ops import distance as dist_mod
    from emosaic_tpu.ops.distance import l1_topk_twolevel

    lib = np.tile(rng.integers(0, 256, size=(1, 12), dtype=np.uint8), (700, 1))
    blocks = rng.integers(0, 256, size=(9, 12), dtype=np.uint8)
    k = 10
    d, r = l1_topk_twolevel(blocks, lib, k)
    assert (r == np.arange(k)[None, :]).all()
    assert (d == d[:, :1]).all()


def test_l1_topk_twolevel_clustered_segment(rng):
    # a segment packed with more than _TL_CAP near-duplicates of the query
    # must be caught by the certificate (stage-1 truncation would
    # otherwise drop true top-k members)
    from emosaic_tpu.ops.distance import _TL_CAP, l1_topk_stripes, l1_topk_twolevel

    lib = rng.integers(100, 256, size=(640, 12), dtype=np.uint8)
    q = rng.integers(0, 40, size=(12,), dtype=np.uint8)
    # 3*_TL_CAP almost-identical rows inside segment 1 (cols 128..151)
    for i in range(3 * _TL_CAP):
        lib[128 + i] = np.clip(q.astype(np.int32) + i % 3, 0, 255)
    blocks = np.stack([q, rng.integers(0, 256, size=(12,), dtype=np.uint8)])
    k = 2 * _TL_CAP
    d_o, r_o = l1_topk_stripes(blocks, lib, k)
    d_t, r_t = l1_topk_twolevel(blocks, lib, k)
    assert (d_t == d_o).all()
    assert (r_t == r_o).all()


def test_l1_topk_twolevel_k_exceeds_cap_capacity(rng):
    # k too large for nseg*cap -> plain stripes path, same contract
    from emosaic_tpu.ops.distance import I32_MAX, l1_topk_twolevel

    lib = rng.integers(0, 256, size=(130, 3), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(6, 3), dtype=np.uint8)
    d, r = l1_topk_twolevel(blocks, lib, 140)
    assert d.shape == (6, 140)
    assert (d[:, 130:] == I32_MAX).all()


@pytest.mark.parametrize("seed,b,l,d,k", [(0, 33, 129, 3, 1), (1, 64, 400, 12, 20), (2, 17, 1000, 48, 64), (3, 5, 257, 27, 257)])
def test_l1_topk_twolevel_fuzz(seed, b, l, d, k):
    # min-identity + segmentation across odd shapes, k at boundaries
    from emosaic_tpu.ops.distance import l1_topk_stripes, l1_topk_twolevel

    r = np.random.default_rng(seed)
    lib = r.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = r.integers(0, 256, size=(b, d), dtype=np.uint8)
    blocks[0] = lib[l // 2]  # zero-distance hit
    d_o, r_o = l1_topk_stripes(blocks, lib, k)
    d_t, r_t = l1_topk_twolevel(blocks, lib, k)
    np.testing.assert_array_equal(d_t, d_o)
    np.testing.assert_array_equal(r_t, r_o)


def test_l1_argmin_stripes_matches_oracle(rng):
    # min-identity argmin (high-D matched path) vs the XLA oracle,
    # duplicate rows forcing lowest-row tie-breaks
    from emosaic_tpu.ops.distance import l1_argmin_stripes, l1_argmin_xla

    base = rng.integers(0, 256, size=(60, 27), dtype=np.uint8)
    lib = np.concatenate([base, base[:20]], axis=0)
    blocks = rng.integers(0, 256, size=(41, 27), dtype=np.uint8)
    blocks[0] = lib[65]  # exact hit on a duplicated row -> lower twin wins
    d_s, r_s = l1_argmin_stripes(blocks, lib)
    d_o, r_o = l1_argmin_xla(blocks, lib)
    np.testing.assert_array_equal(np.asarray(d_s), np.asarray(d_o))
    np.testing.assert_array_equal(np.asarray(r_s), np.asarray(r_o))


def _clustered_case(rng, l=2000, d=48, planted=8):
    # high-valued random library + a handful of planted near-matches of a
    # low-valued query: coarse group-sums see the systematic shift, so
    # the certified prune holds (the realistic photomosaic regime)
    lib = rng.integers(100, 256, size=(l, d), dtype=np.uint8)
    q = rng.integers(0, 20, size=(d,), dtype=np.uint8)
    for i in range(planted):
        lib[rng.integers(0, l)] = np.clip(
            q.astype(np.int32) + rng.integers(0, 3, size=d), 0, 255
        )
    blocks = np.stack([q, np.clip(q + 1, 0, 255).astype(np.uint8)])
    return blocks, lib


def test_l1_topk_adaptive_certified_on_clustered(rng):
    from emosaic_tpu.ops.distance import l1_topk_adaptive

    blocks, lib = _clustered_case(rng)
    k = 8
    d_o, r_o = l1_topk(blocks, lib, k)
    d_a, r_a = l1_topk_adaptive(blocks, lib, k, m=32, cap=4)
    np.testing.assert_array_equal(d_a, np.asarray(d_o))
    np.testing.assert_array_equal(r_a, np.asarray(r_o))


def test_l1_topk_adaptive_exact_on_concentrated_random(rng):
    # uniform-random data: distances concentrate, the coarse bound cannot
    # prune -> the gate (or per-row certificates) must keep it exact
    from emosaic_tpu.ops.distance import l1_topk_adaptive

    lib = rng.integers(0, 256, size=(1500, 48), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(17, 48), dtype=np.uint8)
    k = 6
    d_o, r_o = l1_topk(blocks, lib, k)
    d_a, r_a = l1_topk_adaptive(blocks, lib, k, m=32, cap=4)
    np.testing.assert_array_equal(d_a, np.asarray(d_o))
    np.testing.assert_array_equal(r_a, np.asarray(r_o))


def test_l1_topk_adaptive_tie_storm(rng):
    # duplicated planted rows force exact ties across the permutation;
    # the final (distance, original row) sort must restore lowest-row order
    from emosaic_tpu.ops.distance import l1_topk_adaptive

    blocks, lib = _clustered_case(rng, planted=0)
    q = blocks[0]
    for pos in (3, 700, 1100, 1999):
        lib[pos] = q  # four identical zero-distance rows
    k = 6
    d_o, r_o = l1_topk(blocks, lib, k)
    d_a, r_a = l1_topk_adaptive(blocks, lib, k, m=32, cap=4)
    np.testing.assert_array_equal(d_a, np.asarray(d_o))
    np.testing.assert_array_equal(r_a, np.asarray(r_o))


def test_ad_params_scaling_rule():
    # the anchors: 200k rows (nseg=1563) keeps m=1024/cap=8; 1M rows
    # (nseg=7813) needs m=4096 for ~100% certification; small libraries
    # keep the defaults and explicit tiny (m, cap) pass through.
    from emosaic_tpu.ops.distance import _ad_params

    assert _ad_params(100) == (1024, 16)
    assert _ad_params(1563) == (1024, 8)
    assert _ad_params(2048) == (1024, 8)
    assert _ad_params(2049) == (2048, 8)
    assert _ad_params(7813) == (4096, 8)
    assert _ad_params(16, 32, 4) == (32, 4)


def test_ad_b_slice_survivor_budget():
    # the slice length shrinks with nseg so the [slice, nseg*cap] i32 x2
    # survivor lists never outgrow the _AD_SURV_BYTES budget; 200k-row
    # regime keeps the full 16384-row slice, megascale shrinks it
    from emosaic_tpu.ops.distance import _AD_SURV_BYTES, _ad_b_slice

    assert _ad_b_slice(1563, 8, 128) == 16384
    assert _ad_b_slice(7813, 8, 128) == 4224
    assert _ad_b_slice(15625, 8, 128) == 2048
    assert _ad_b_slice(17, 16, 8) == 16384  # tiny library: full slice
    for nseg, cap, bc in [(1563, 8, 128), (7813, 8, 128), (15625, 8, 128)]:
        sl = _ad_b_slice(nseg, cap, bc)
        assert sl % bc == 0 and sl * nseg * cap * 8 <= _AD_SURV_BYTES


def test_l1_topk_adaptive_small_cases_route_to_twolevel(rng):
    from emosaic_tpu.ops.distance import l1_topk_adaptive

    lib = rng.integers(0, 256, size=(100, 12), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(5, 12), dtype=np.uint8)
    d_o, r_o = l1_topk(blocks, lib, 110)  # k > L and l <= 2m
    d_a, r_a = l1_topk_adaptive(blocks, lib, 110)
    np.testing.assert_array_equal(d_a, np.asarray(d_o))
    np.testing.assert_array_equal(r_a, np.asarray(r_o))


def test_l1_topk_routes_large_through_adaptive(rng, monkeypatch):
    """Above the matrix budget l1_topk routes through the adaptive
    certified scorer; results must stay bit-identical to the oracle."""
    from emosaic_tpu.ops import distance

    lib = rng.integers(0, 256, size=(900, 48), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(33, 48), dtype=np.uint8)
    d_ref, r_ref = distance.l1_topk_stripes(blocks, lib, 7)
    monkeypatch.setattr(distance, "_TOPK_MATRIX_BUDGET", 100)
    d_a, r_a = distance.l1_topk(blocks, lib, 7)
    np.testing.assert_array_equal(d_a, np.asarray(d_ref))
    np.testing.assert_array_equal(r_a, np.asarray(r_ref))


def test_adaptive_k1_argmin_tie_break(rng):
    """The k=1 adaptive route (repeat-mode argmin at scale) must keep the
    lowest-row tie-break even with duplicated library rows."""
    from emosaic_tpu.ops.distance import l1_argmin_xla, l1_topk_adaptive

    base = rng.integers(0, 256, size=(1500, 48), dtype=np.uint8)
    lib = base.copy()
    lib[1200:1250] = lib[100:150]  # exact duplicates -> ties
    blocks = lib[rng.integers(0, 1500, size=40)]
    da, ra = l1_topk_adaptive(blocks, lib, 1, m=32, cap=4)
    dx, rx = l1_argmin_xla(blocks, lib)
    np.testing.assert_array_equal(da[:, 0], np.asarray(dx))
    np.testing.assert_array_equal(ra[:, 0], np.asarray(rx))


@pytest.mark.parametrize("l", [17000, 20000])
def test_l1_topk_hybrid_arbitrary_library_sizes(rng, l):
    """Regression: non-power-of-two prefilter chunks (l just above 16384)
    crashed the rescore reshape; the chunk is now a power of two."""
    from emosaic_tpu.ops.distance import l1_topk_hybrid

    lib = rng.integers(0, 256, size=(l, 12), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(9, 12), dtype=np.uint8)
    d, r = l1_topk_hybrid(blocks, lib, 2)
    ref = np.abs(
        blocks.astype(np.int64) - lib[r[:, 0]].astype(np.int64)
    ).sum(-1)
    assert (d[:, 0] == ref).all()
    assert (d[:, 0] <= d[:, 1]).all()


def test_l1_topk_adaptive_stride_aligned_cluster_stays_exact(rng):
    """Adversarial layout for the STRIDED segmentation: a tight cluster
    placed at exactly the segment stride lands entirely in ONE segment,
    overflowing its cap — the per-row certificate must detect it and the
    fallback keep results bit-exact."""
    from emosaic_tpu.ops.distance import _TL_SEG, l1_topk_adaptive

    d, cap, m, k = 48, 4, 32, 8
    l = 4 * _TL_SEG * 4  # lp = l, nseg = l // _TL_SEG... stride = nseg
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    lp = -(-l // _TL_SEG) * _TL_SEG
    nseg = lp // _TL_SEG
    q = rng.integers(0, 256, size=(1, d), dtype=np.uint8)
    # 12 near-duplicates of q at rows {7, 7+nseg, 7+2*nseg, ...}:
    # all map to segment 7 under col = k*nseg + s
    for i in range(12):
        r = 7 + i * nseg
        lib[r] = np.clip(q[0].astype(np.int32) + (i % 3) - 1, 0, 255)
    blocks = np.vstack([q, rng.integers(0, 256, size=(7, d), dtype=np.uint8)])
    d_a, r_a = l1_topk_adaptive(blocks, lib, k, m=m, cap=cap)
    d_o, r_o = l1_topk(blocks, lib, k)
    np.testing.assert_array_equal(d_a, np.asarray(d_o))
    np.testing.assert_array_equal(r_a, np.asarray(r_o))


@pytest.mark.parametrize(
    "seed,dist_kind,b,l,d,k,m,cap",
    # shapes chosen to PASS the adaptive entry gates (m+1 <= nseg*cap,
    # l > 2m, valid channel grouping g) — asserted below, so the fuzz
    # really exercises the coarse/rescore/certificate machinery
    [
        (0, "clustered", 24, 2200, 48, 8, 64, 8),
        (1, "uniform", 16, 2048, 96, 5, 64, 8),
        (2, "clustered", 9, 3000, 96, 16, 96, 8),
        (3, "dupes", 20, 2500, 24, 32, 64, 8),  # k at m/2 boundary
    ],
)
def test_l1_topk_adaptive_fuzz(seed, dist_kind, b, l, d, k, m, cap):
    """Adaptive scorer across data distributions and odd shapes — must be
    bit-identical to the stripe oracle whichever internal route
    (certified / per-row fallback / sample-gate reroute) fires."""
    from emosaic_tpu.ops import distance as dist_mod
    from emosaic_tpu.ops.distance import l1_topk_adaptive, l1_topk_stripes

    r = np.random.default_rng(seed)
    if dist_kind == "uniform":
        lib = r.integers(0, 256, size=(l, d), dtype=np.uint8)
    else:
        centers = r.integers(0, 256, size=(8, d))
        lib = np.clip(
            centers[r.integers(0, 8, l)] + r.normal(0, 9, (l, d)), 0, 255
        ).astype(np.uint8)
        if dist_kind == "dupes":
            lib[l // 2 :] = lib[: l - l // 2]  # massive tie pressure
    blocks = lib[r.integers(0, l, b)].copy()
    blocks[0] = lib[l // 3]  # exact hit
    d_o, r_o = l1_topk_stripes(blocks, lib, k)
    coarse_calls = []
    orig_coarse = dist_mod._ad_coarse_jit

    def spy(*a, **kw):
        coarse_calls.append(1)
        return orig_coarse(*a, **kw)

    dist_mod._ad_coarse_jit = spy
    try:
        d_a, r_a = l1_topk_adaptive(blocks, lib, k, m=m, cap=cap)
    finally:
        dist_mod._ad_coarse_jit = orig_coarse
    assert coarse_calls, "shapes rerouted at the entry gate — fuzz is dead"
    np.testing.assert_array_equal(d_a, np.asarray(d_o))
    np.testing.assert_array_equal(r_a, np.asarray(r_o))


def test_l1_topk_adaptive_large_nseg_cap_reduction(rng):
    """Libraries beyond 1024 segments (131072+ rows) reduce cap to 8
    (round-3 perf heuristic); results must stay exactly the l1_topk
    contract. Small d keeps the CPU cost sane at L=140k."""
    from emosaic_tpu.ops.distance import l1_topk_adaptive

    d, l, k = 48, 140_000, 4
    # clustered: repeated bases + jitter, in discovery-order runs
    bases = rng.integers(0, 256, size=(200, d))
    lib = np.clip(
        np.repeat(bases, l // 200, axis=0)
        + rng.integers(-5, 6, size=(l, d)),
        0,
        255,
    ).astype(np.uint8)
    blocks = np.clip(
        lib[rng.integers(0, l, size=6)].astype(np.int32)
        + rng.integers(-3, 4, size=(6, d)),
        0,
        255,
    ).astype(np.uint8)
    d_o, r_o = l1_topk(blocks, lib, k)
    d_a, r_a = l1_topk_adaptive(blocks, lib, k, m=32)
    np.testing.assert_array_equal(d_a, np.asarray(d_o))
    np.testing.assert_array_equal(r_a, np.asarray(r_o))


def test_tint_sample_grid_matches_device_f32():
    """The host-computed nearest-sample grid must reproduce the on-device
    f32 arithmetic it replaced, op for op — f64 picks different source
    rows near rounding boundaries for ~half of (sh, out_h) pairs."""
    import jax
    import jax.numpy as jnp

    from emosaic_tpu.ops.composite import _tint_sample_indices

    def device_f32(bh, ow, sh, sw, out_h, y0):
        yi = jnp.clip(
            ((jnp.arange(y0, y0 + bh) + 0.5) * (sh / out_h)).astype(jnp.int32),
            0, sh - 1,
        )
        xi = jnp.clip(
            ((jnp.arange(ow) + 0.5) * (sw / ow)).astype(jnp.int32), 0, sw - 1
        )
        xi3 = (xi[:, None] * 3 + jnp.arange(3)[None, :]).reshape(-1)
        return np.asarray(yi), np.asarray(xi3)

    rng = np.random.default_rng(7)
    cases = [(512, 97, 4255, 97, 27023, 1024)]  # known f64-divergent pair
    for _ in range(25):
        sh = int(rng.integers(1, 6000))
        out_h = int(rng.integers(1, 30000))
        sw = int(rng.integers(1, 3000))
        ow = int(rng.integers(1, 3000))
        bh = int(rng.integers(1, 200))
        y0 = int(rng.integers(0, max(1, out_h - bh)))
        cases.append((bh, ow, sh, sw, out_h, y0))
    for c in cases:
        a = _tint_sample_indices(*c)
        b = device_f32(*c)
        assert (a[0] == b[0]).all() and (a[1] == b[1]).all(), c


def test_l1_topk_adaptive_block_slicing(rng, monkeypatch):
    """Huge-B runs slice the block axis (bounded survivor memory); the
    sliced path must be bit-equal to the oracle across slice joins.

    b=300 with bc=128 and _AD_B_SLICE=256 gives bp=384 and TWO slices:
    one full 256-row slice plus a 128-row REMAINDER (the second compiled
    shape) — both the slice join and the tail-shape arm genuinely
    engage (round-3 reviews caught two earlier variants where the loop
    ran once, or ran thrice with no remainder)."""
    from emosaic_tpu.ops import distance

    monkeypatch.setattr(distance, "_AD_B_SLICE", 256)
    d, l, k, b = 48, 3000, 4, 300
    bases = rng.integers(0, 256, size=(50, d))
    lib = np.clip(
        np.repeat(bases, l // 50, axis=0) + rng.integers(-5, 6, size=(l, d)),
        0,
        255,
    ).astype(np.uint8)
    blocks = np.clip(
        lib[rng.integers(0, l, size=b)].astype(np.int32)
        + rng.integers(-3, 4, size=(b, d)),
        0,
        255,
    ).astype(np.uint8)
    # confirm the slicing arithmetic this test depends on: one full
    # slice AND a strictly smaller remainder
    bc = min(distance._STRIPE_BC, max(8, 1 << (b - 1).bit_length()))
    bp = -(-b // bc) * bc
    assert bp > 256 and bp % 256 != 0
    d_o, r_o = l1_topk(blocks, lib, k)
    d_a, r_a = distance.l1_topk_adaptive(blocks, lib, k, m=32)
    np.testing.assert_array_equal(d_a, np.asarray(d_o))
    np.testing.assert_array_equal(r_a, np.asarray(r_o))


def test_l1_topk_streamed_parity_ragged_banks_with_ties(rng):
    """Host-bank streaming (library > device budget) must be bit-equal
    to the direct scorer, including ties that straddle bank boundaries:
    low-cardinality palettes make equal distances land in DIFFERENT
    banks, so the cross-bank merge's lowest-global-row tie-break
    genuinely engages. bank_rows=256 over L=1000 gives three full banks
    plus a 232-row ragged tail."""
    from emosaic_tpu.ops import distance

    l, d, k = 1000, 12, 20
    lib = (rng.integers(0, 3, size=(l, d)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(32, d)) * 16).astype(np.uint8)
    d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
    d_s, r_s = distance.l1_topk_streamed(blocks, lib, k, bank_rows=256)
    np.testing.assert_array_equal(d_s, np.asarray(d_o))
    np.testing.assert_array_equal(r_s, np.asarray(r_o))


def test_fold_topk_host_contract():
    """The shared running-top-k fold (`_fold_topk_host` — the one merge
    `l1_topk_streamed` and the audit oracle `_stripes_banked` both use)
    pins its contract directly: sorted by (distance, lowest GLOBAL row)
    with cross-chunk ties resolved to the lower row regardless of which
    chunk held it, I32_MAX padding always losing, and `None` starting
    the fold by adopting the first chunk as-is."""
    from emosaic_tpu.ops.distance import I32_MAX, _fold_topk_host

    l, kk = 1000, 3
    # chunk A rows {10: d5, 500: d7, pad}; chunk B rows {3: d5, 900: d6}
    a_d = np.array([[5, 7, I32_MAX]], np.int32)
    a_r = np.array([[10, 500, 0]], np.int32)
    b_d = np.array([[5, 6, I32_MAX]], np.int32)
    b_r = np.array([[3, 900, 0]], np.int32)
    d0, r0 = _fold_topk_host(None, None, a_d, a_r, kk, l)
    assert d0 is a_d and r0 is a_r  # first chunk adopted unchanged
    fd, fr = _fold_topk_host(d0, r0, b_d, b_r, kk, l)
    # d5 tie between rows 10 (chunk A) and 3 (chunk B): row 3 first
    np.testing.assert_array_equal(fd, [[5, 5, 6]])
    np.testing.assert_array_equal(fr, [[3, 10, 900]])
    # fold order must not matter (the streamed scorer folds bank by
    # bank in upload order; the audit oracle in chunk order)
    fd2, fr2 = _fold_topk_host(b_d, b_r, a_d, a_r, kk, l)
    np.testing.assert_array_equal(fd2, fd)
    np.testing.assert_array_equal(fr2, fr)


def test_l1_topk_streamed_k_exceeds_bank_and_library(rng):
    """k larger than a bank (every bank contributes ALL its rows) and k
    larger than the whole library (trailing I32_MAX/row-0 padding) both
    keep the shared top-k conventions through the merge."""
    from emosaic_tpu.ops import distance
    from emosaic_tpu.ops.distance import I32_MAX

    l, d = 600, 12
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(9, d), dtype=np.uint8)
    for k in (300, 1200):  # > bank_rows=256 / > L
        d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
        d_s, r_s = distance.l1_topk_streamed(blocks, lib, k, bank_rows=256)
        np.testing.assert_array_equal(d_s, np.asarray(d_o))
        np.testing.assert_array_equal(r_s, np.asarray(r_o))
    assert (d_s[:, l:] == I32_MAX).all() and (r_s[:, l:] == 0).all()


def test_l1_topk_adaptive_gate_routes_oversized_to_streamed(rng, monkeypatch):
    """Above _DEVICE_LIB_BYTES_MAX the adaptive entry streams host banks
    (this is how production no-repeat runs reach beyond-HBM libraries);
    banks are clamped under the budget so the per-bank adaptive calls
    never re-enter the gate, and results stay bit-identical."""
    from emosaic_tpu.ops import distance

    l, d, k = 3000, 48, 4
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(33, d), dtype=np.uint8)
    d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
    calls = []
    real = distance.l1_topk_streamed

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(distance, "l1_topk_streamed", spy)
    # budget of 1024 rows' worth -> three banks (1024 + 1024 + 952)
    monkeypatch.setattr(
        distance, "_DEVICE_LIB_BYTES_MAX", 1024 * d
    )
    d_a, r_a = distance.l1_topk_adaptive(blocks, lib, k)
    assert len(calls) == 1  # gated once; per-bank calls stay direct
    np.testing.assert_array_equal(d_a, np.asarray(d_o))
    np.testing.assert_array_equal(r_a, np.asarray(r_o))


def test_stream_bank_rows_fits_one_dma_bank(monkeypatch):
    """Default streamed banks must equal `_dma_bank_rows` at the row
    width — the property that makes `_lib_banks` return a 1-tuple (the
    single-buffer device path) for every uploaded bank, full or ragged."""
    from emosaic_tpu.ops import distance

    monkeypatch.setattr(distance, "_DEVICE_LIB_BYTES_MAX", 6_200_000_000)
    for d in (12, 48, 192, 768, 3072, 49152):
        rb = distance._stream_bank_rows(d)
        assert rb == max(distance._TL_SEG, distance._dma_bank_rows(d))
        assert rb % distance._TL_SEG == 0
        assert rb * d <= distance._DMA_LIB_BYTES_MAX
        assert rb * d <= distance._DEVICE_LIB_BYTES_MAX


def test_l1_argmin_oversized_library_streams(rng, monkeypatch):
    """Past the device-resident budget l1_argmin must stream host banks
    instead of uploading the library whole; k=1 through the cross-bank
    merge keeps the exact lowest-row tie-break (low-cardinality palette
    forces ties across bank boundaries)."""
    from emosaic_tpu.ops import distance

    l, d = 3000, 48
    lib = (rng.integers(0, 3, size=(l, d)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(25, d)) * 16).astype(np.uint8)
    d_o, r_o = distance.l1_argmin_xla(blocks, lib)
    calls = []
    real = distance.l1_topk_streamed

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(distance, "l1_topk_streamed", spy)
    monkeypatch.setattr(distance, "_DEVICE_LIB_BYTES_MAX", 1024 * d)
    d_a, r_a = distance.l1_argmin(blocks, lib)
    assert calls  # the gate engaged
    np.testing.assert_array_equal(np.asarray(d_a), np.asarray(d_o))
    np.testing.assert_array_equal(np.asarray(r_a), np.asarray(r_o))


def test_l1_topk_hybrid_oversized_library_streams_exact(rng, monkeypatch):
    """Past the budget the hybrid's matmul prefilter cannot hold the
    library; the gate reroutes to the streamed scorer — which upgrades
    the hybrid contract to a fully EXACT candidate set."""
    from emosaic_tpu.ops import distance

    l, d, k = 3000, 48, 7
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(21, d), dtype=np.uint8)
    d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
    monkeypatch.setattr(distance, "_DEVICE_LIB_BYTES_MAX", 1024 * d)
    d_h, r_h = distance.l1_topk_hybrid(blocks, lib, k)
    np.testing.assert_array_equal(d_h, np.asarray(d_o))
    np.testing.assert_array_equal(r_h, np.asarray(r_o))


def test_l1_topk_streamed_custom_scorer(rng):
    """The per-bank scorer is pluggable (the mesh-sharded scorer passes a
    closure): every bank must route through it, results unchanged."""
    from emosaic_tpu.ops import distance

    l, d, k = 1000, 12, 5
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(16, d), dtype=np.uint8)
    banks = []

    def scorer(bb, ll, kx):
        banks.append(ll.shape[0])
        return distance.l1_topk_stripes(bb, ll, kx)

    d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
    d_s, r_s = distance.l1_topk_streamed(
        blocks, lib, k, bank_rows=256, scorer=scorer
    )
    assert banks == [256, 256, 256, 232]
    np.testing.assert_array_equal(d_s, np.asarray(d_o))
    np.testing.assert_array_equal(r_s, np.asarray(r_o))


def test_oversized_gates_zero_blocks_no_recursion(rng, monkeypatch):
    """b=0 against a beyond-budget library must return empty results
    directly — re-entering a scorer would bounce between the gates and
    the streamer forever (review finding: mutual recursion)."""
    from emosaic_tpu.ops import distance

    l, d, k = 3000, 48, 5
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = np.empty((0, d), np.uint8)
    monkeypatch.setattr(distance, "_DEVICE_LIB_BYTES_MAX", 1024 * d)
    d_a, r_a = distance.l1_topk_adaptive(blocks, lib, k)
    assert d_a.shape == (0, k) and r_a.shape == (0, k)
    d_m, r_m = distance.l1_argmin(blocks, lib)
    assert np.asarray(d_m).shape == (0,) and np.asarray(r_m).shape == (0,)
    d_h, r_h = distance.l1_topk_hybrid(blocks, lib, k)
    assert d_h.shape == (0, k) and r_h.shape == (0, k)


def test_l1_topk_small_b_oversized_library_streams(rng, monkeypatch):
    """The dense-matrix dispatch (small B*L) must not upload a
    beyond-budget library: small-B shapes route through the adaptive
    gate's streamer instead (review finding), results unchanged."""
    from emosaic_tpu.ops import distance

    l, d, k = 3000, 48, 6
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(5, d), dtype=np.uint8)  # b*l tiny
    d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
    calls = []
    real = distance.l1_topk_streamed

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(distance, "l1_topk_streamed", spy)
    monkeypatch.setattr(distance, "_DEVICE_LIB_BYTES_MAX", 1024 * d)
    d_t, r_t = distance.l1_topk(blocks, lib, k)
    assert calls  # streamed, not dense-matrix uploaded
    np.testing.assert_array_equal(d_t, np.asarray(d_o))
    np.testing.assert_array_equal(r_t, np.asarray(r_o))


def test_streamed_dispatch_fuzz(rng):
    """Seeded sweep over the streamed/banked dispatch space: random
    shapes, tie-dense palettes, k, and bank widths — streamed output
    must equal the stripes oracle bit-for-bit in every draw (ragged
    banks, k spanning banks, duplicate rows, single-bank degenerate)."""
    from emosaic_tpu.ops import distance

    for trial in range(8):
        l = int(rng.integers(10, 1200))
        d = int(rng.integers(1, 5)) * 3
        b = int(rng.integers(1, 33))
        k = int(rng.integers(1, min(l, 600) + 1))
        card = int(rng.integers(2, 9))
        q = 255 // (card - 1)
        lib = (rng.integers(0, card, size=(l, d)) * q).astype(np.uint8)
        blocks = (rng.integers(0, card, size=(b, d)) * q).astype(np.uint8)
        bank = int(rng.integers(1, 9)) * distance._TL_SEG
        d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
        d_s, r_s = distance.l1_topk_streamed(blocks, lib, k, bank_rows=bank)
        msg = f"trial {trial}: l={l} d={d} b={b} k={k} bank={bank}"
        np.testing.assert_array_equal(d_s, np.asarray(d_o), err_msg=msg)
        np.testing.assert_array_equal(r_s, np.asarray(r_o), err_msg=msg)


def test_l1_topk_adaptive_prepared_banks_bit_identical(rng):
    """An `_ad_prepare` handle (the streamed scorer's prefetch) must make
    the adaptive scorer skip its internal upload yet return bit-identical
    results; a handle from a DIFFERENT library shape is refused rather
    than silently scoring wrong banks."""
    from emosaic_tpu.ops import distance

    l, d, k = 2000, 48, 4
    bases = rng.integers(0, 256, size=(40, d))
    lib = np.clip(
        np.repeat(bases, l // 40, axis=0) + rng.integers(-5, 6, size=(l, d)),
        0,
        255,
    ).astype(np.uint8)
    blocks = np.clip(
        lib[rng.integers(0, l, size=33)].astype(np.int32)
        + rng.integers(-3, 4, size=(33, d)),
        0,
        255,
    ).astype(np.uint8)
    d_o, r_o = distance.l1_topk_adaptive(blocks, lib, k, m=32)
    handle = distance._ad_prepare(lib, d)
    d_p, r_p = distance.l1_topk_adaptive(
        blocks, lib, k, m=32, prepared=handle
    )
    np.testing.assert_array_equal(d_p, d_o)
    np.testing.assert_array_equal(r_p, r_o)
    with pytest.raises(ValueError, match="prepared banks"):
        distance.l1_topk_adaptive(
            blocks, lib[: l - 500], k, m=32, prepared=handle
        )


def test_l1_topk_streamed_prefetch_delivers_prepared(rng, monkeypatch):
    """Scorers exposing `prepare` must receive every bank's pre-uploaded
    handle (issued one bank ahead from the worker thread); with
    EMOSAIC_STREAM_PREFETCH=0 the same scorer runs without handles.
    Results bit-equal the stripes oracle both ways."""
    from emosaic_tpu.ops import distance

    l, d, k = 900, 12, 6
    lib = (rng.integers(0, 3, size=(l, d)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(17, d)) * 16).astype(np.uint8)
    got = []

    def scorer(bb, ll, kx, prepared=None):
        got.append(None if prepared is None else prepared[1])
        if prepared is not None:
            banks, rows = prepared
            assert rows == ll.shape[0]
            lp = -(-rows // distance._TL_SEG) * distance._TL_SEG
            assert sum(bk.size for bk in banks) == lp * d
        return distance.l1_topk_stripes(bb, ll, kx)

    # this scorer consumes every handle: prepare unconditionally (the
    # b/k protocol args are for scorers with handle-ignoring fallbacks)
    scorer.prepare = lambda ll, dd_, b=None, kx=None: distance._ad_prepare(
        ll, dd_
    )
    d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
    d_s, r_s = distance.l1_topk_streamed(
        blocks, lib, k, bank_rows=256, scorer=scorer
    )
    assert got == [256, 256, 256, 132]  # every bank got its handle
    np.testing.assert_array_equal(d_s, np.asarray(d_o))
    np.testing.assert_array_equal(r_s, np.asarray(r_o))
    got.clear()
    monkeypatch.setenv("EMOSAIC_STREAM_PREFETCH", "0")
    d_n, r_n = distance.l1_topk_streamed(
        blocks, lib, k, bank_rows=256, scorer=scorer
    )
    assert got == [None, None, None, None]
    np.testing.assert_array_equal(d_n, d_s)
    np.testing.assert_array_equal(r_n, r_s)


def test_l1_topk_streamed_prefetch_halves_auto_banks(rng, monkeypatch):
    """With prefetch, two banks are device-resident at once, so AUTO bank
    sizing must halve to stay inside _DEVICE_LIB_BYTES_MAX; an explicit
    bank_rows is honored as given (prior test). Prefetch off keeps the
    full-budget bank."""
    from emosaic_tpu.ops import distance

    l, d, k = 3000, 48, 3
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(9, d), dtype=np.uint8)
    monkeypatch.setattr(distance, "_DEVICE_LIB_BYTES_MAX", 1024 * d)
    seen = []

    def scorer(bb, ll, kx, prepared=None):
        seen.append(ll.shape[0])
        return distance.l1_topk_stripes(bb, ll, kx)

    scorer.prepare = distance._ad_prepare
    d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
    d_s, r_s = distance.l1_topk_streamed(blocks, lib, k, scorer=scorer)
    assert seen == [512] * 5 + [440]  # halved from the 1024-row budget
    np.testing.assert_array_equal(d_s, np.asarray(d_o))
    np.testing.assert_array_equal(r_s, np.asarray(r_o))
    seen.clear()
    monkeypatch.setenv("EMOSAIC_STREAM_PREFETCH", "0")
    distance.l1_topk_streamed(blocks, lib, k, scorer=scorer)
    assert seen == [1024, 1024, 952]


def test_l1_topk_streamed_explicit_bank_over_half_budget_goes_serial(
    rng, monkeypatch, capsys
):
    """An explicit bank_rows is honored as given (no halving), so when two
    such banks cannot both fit _DEVICE_LIB_BYTES_MAX the streamer must
    fall back to SERIAL streaming (no prepared handles) instead of
    prefetching 2x the proven device envelope; a smaller explicit bank
    that does fit twice keeps prefetch on. Results bit-equal either way."""
    from emosaic_tpu.ops import distance

    l, d, k = 3000, 48, 3
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(9, d), dtype=np.uint8)
    monkeypatch.setattr(distance, "_DEVICE_LIB_BYTES_MAX", 1024 * d)
    handles = []

    def scorer(bb, ll, kx, prepared=None):
        handles.append(prepared is not None)
        return distance.l1_topk_stripes(bb, ll, kx)

    scorer.prepare = lambda ll, dd_, b=None, kx=None: distance._ad_prepare(
        ll, dd_
    )
    d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
    # 1024-row banks: one fits the budget exactly, two do not -> serial
    d_s, r_s = distance.l1_topk_streamed(
        blocks, lib, k, bank_rows=1024, scorer=scorer
    )
    assert handles == [False, False, False]
    # the lost upload overlap must be LOUD (the r23 streamproof depends
    # on noticing this; a silent serial fallback misleads perf numbers)
    assert "prefetch disabled" in capsys.readouterr().err
    np.testing.assert_array_equal(d_s, np.asarray(d_o))
    np.testing.assert_array_equal(r_s, np.asarray(r_o))
    handles.clear()
    # 512-row banks: two fit -> prefetch stays on, every bank has a handle
    d_p, r_p = distance.l1_topk_streamed(
        blocks, lib, k, bank_rows=512, scorer=scorer
    )
    assert handles == [True] * 6
    np.testing.assert_array_equal(d_p, np.asarray(d_o))
    np.testing.assert_array_equal(r_p, np.asarray(r_o))


def test_ad_prepare_declines_ineligible_banks(rng):
    """With the query shape supplied, `_ad_prepare` must return None for
    banks `_ad_plan` would route to the two-level scorer (which ignores
    `prepared` and uploads the library itself — a prefetched handle
    would be pure waste plus transient extra device memory), and the
    streamer must still produce exact results with those None handles
    flowing through the default adaptive scorer."""
    from emosaic_tpu.ops import distance

    l, d, k = 900, 12, 6
    lib = (rng.integers(0, 3, size=(l, d)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(17, d)) * 16).astype(np.uint8)
    # a 256-row bank at d=12 fails the l > 2*m eligibility arm
    assert not distance._ad_plan(17, 256, d, k)[0]
    assert distance._ad_prepare(lib[:256], d, 17, k) is None
    # without the query shape (direct use) it still prepares
    assert distance._ad_prepare(lib[:256], d) is not None
    d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
    d_s, r_s = distance.l1_topk_streamed(blocks, lib, k, bank_rows=256)
    np.testing.assert_array_equal(d_s, np.asarray(d_o))
    np.testing.assert_array_equal(r_s, np.asarray(r_o))
    # an eligible production-like shape DOES get a handle (default
    # m=1024 needs l > 2m and nseg*cap >= m+1, i.e. l >= 8320)
    lc, dc = 9000, 48
    lib_c = rng.integers(0, 256, size=(lc, dc), dtype=np.uint8)
    assert distance._ad_plan(33, lc, dc, 4)[0]
    assert distance._ad_prepare(lib_c, dc, 33, 4) is not None


def test_l1_topk_streamed_prefetch_error_propagates(rng):
    """An exception inside the worker-thread prepare must surface to the
    caller (fut.result re-raises), not be swallowed."""
    from emosaic_tpu.ops import distance

    l, d, k = 600, 12, 3
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(4, d), dtype=np.uint8)

    def scorer(bb, ll, kx, prepared=None):
        return distance.l1_topk_stripes(bb, ll, kx)

    def bad_prepare(ll, dd, b=None, kx=None):
        raise RuntimeError("prefetch boom")

    scorer.prepare = bad_prepare
    with pytest.raises(RuntimeError, match="prefetch boom"):
        distance.l1_topk_streamed(blocks, lib, k, bank_rows=256, scorer=scorer)


def test_l2_argmin_streams_beyond_budget(rng, monkeypatch):
    """l2_argmin's matmul path keeps ~3x the library bytes resident (u8 +
    bf16 copy); past the budget it must stream host banks through itself
    (recursion-safe: banks fit 3x inside the budget) and agree with the
    direct kernel."""
    from emosaic_tpu.ops import distance

    l, d = 2000, 12
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(23, d), dtype=np.uint8)
    d_ref, r_ref = map(np.asarray, distance.l2_argmin(blocks, lib))
    monkeypatch.setattr(distance, "_DEVICE_LIB_BYTES_MAX", 512 * d * 3)
    d_s, r_s = map(np.asarray, distance.l2_argmin(blocks, lib))
    np.testing.assert_array_equal(d_s, d_ref)
    np.testing.assert_array_equal(r_s, r_ref)
    # tiny budget: bank floor is _TL_SEG rows; must not recurse forever
    monkeypatch.setattr(distance, "_DEVICE_LIB_BYTES_MAX", 1)
    d_t, r_t = map(np.asarray, distance.l2_argmin(blocks, lib))
    np.testing.assert_array_equal(d_t, d_ref)
    np.testing.assert_array_equal(r_t, r_ref)


# ---------------------------------------------------------------------------
# certificate self-audit (VERDICT r4 #2)
# ---------------------------------------------------------------------------


def test_stripes_banked_matches_stripe_oracle(rng, monkeypatch):
    """The audit's banked stripe oracle must bit-equal l1_topk_stripes
    across multi-bank, multi-chunk, padded-tail, and kc<k geometries."""
    from emosaic_tpu.ops import distance

    l, d = 1000, 16
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = rng.integers(0, 256, size=(9, d), dtype=np.uint8)
    # tiny limits: 4 banks of 256 rows, chunk floor = _TL_SEG (128 rows),
    # k=200 > chunk so the short-chunk padding path runs too
    monkeypatch.setattr(distance, "_DMA_LIB_BYTES_MAX", 512 * d)
    monkeypatch.setattr(distance, "_STRIPE_F32_MAX_BYTES", 1)
    lp = -(-l // distance._TL_SEG) * distance._TL_SEG
    lib_pad = np.zeros((lp, d), np.uint8)
    lib_pad[:l] = lib
    banks = distance._lib_banks(lib_pad, d)
    assert len(banks) > 1
    k = 200
    d_o, r_o = distance.l1_topk_stripes(blocks, lib, k)
    d_b, r_b = distance._stripes_banked(blocks, banks, l, d, k)
    np.testing.assert_array_equal(d_b, np.asarray(d_o))
    np.testing.assert_array_equal(r_b, np.asarray(r_o))


def test_adaptive_audit_catches_certified_lie(rng, monkeypatch, capsys):
    """A stage-level corruption the certificate cannot see (wrong rows
    returned with ok=True for every block — the round-4 2M failure
    class) must be caught by the production self-audit and corrected
    through the independent stripe oracle, loudly."""
    import jax.numpy as jnp

    from emosaic_tpu.ops import distance

    blocks, lib = _clustered_case(rng)
    k = 8
    d_o, r_o = l1_topk(blocks, lib, k)
    real = distance._ad_rescore_jit

    def lying_rescore(bf, vals, cols, s_min, lf, **kw):
        dists, rows, ok = real(bf, vals, cols, s_min, lf, **kw)
        return dists + 1, (rows + 1) % kw["real_l"], jnp.ones_like(ok)

    monkeypatch.setattr(distance, "_ad_rescore_jit", lying_rescore)
    monkeypatch.setenv("EMOSAIC_AUDIT_ROWS", "1")
    d_a, r_a = distance.l1_topk_adaptive(blocks, lib, k, m=32, cap=4)
    np.testing.assert_array_equal(d_a, np.asarray(d_o))
    np.testing.assert_array_equal(r_a, np.asarray(r_o))
    assert "EXACTNESS AUDIT FAILED" in capsys.readouterr().err


def test_adaptive_audit_projection_displacement_stays_exact(
    rng, monkeypatch
):
    """The literal round-4 miscompile signature: every projection chunk
    holds the LAST chunk's values. End-to-end adaptive results must stay
    exact — whichever layer catches it (certificate fallback, adaptivity
    gate, or the audit)."""
    import jax.numpy as jnp

    from emosaic_tpu.ops import distance

    blocks, lib = _clustered_case(rng)
    k = 8
    d_o, r_o = l1_topk(blocks, lib, k)
    real = distance._ad_proj_bank_jit

    def displaced(bf, **kw):
        p = real(bf, **kw)
        n8 = p.shape[0] // 8
        return jnp.concatenate([p[-n8:]] * 8, axis=0)

    monkeypatch.setattr(distance, "_ad_proj_bank_jit", displaced)
    monkeypatch.setenv("EMOSAIC_AUDIT_ROWS", "1")
    d_a, r_a = distance.l1_topk_adaptive(blocks, lib, k, m=32, cap=4)
    np.testing.assert_array_equal(d_a, np.asarray(d_o))
    np.testing.assert_array_equal(r_a, np.asarray(r_o))


def test_adaptive_audit_gating(rng, monkeypatch, capsys):
    """Audit gating knobs: below EMOSAIC_AUDIT_ROWS (or with
    EMOSAIC_AUDIT=0) the audit must not run — pinned by checking that a
    certified lie passes through un-audited at small geometry (the
    documented trade: small libraries are covered by CI parity, the
    audit exists for the multi-GiB class)."""
    import jax.numpy as jnp

    from emosaic_tpu.ops import distance

    blocks, lib = _clustered_case(rng)
    k = 8
    d_o, _ = l1_topk(blocks, lib, k)
    real = distance._ad_rescore_jit

    def lying_rescore(bf, vals, cols, s_min, lf, **kw):
        dists, rows, ok = real(bf, vals, cols, s_min, lf, **kw)
        return dists + 1, rows, jnp.ones_like(ok)

    monkeypatch.setattr(distance, "_ad_rescore_jit", lying_rescore)
    # default threshold (1 << 19) far above this 2000-row library
    d_a, _ = distance.l1_topk_adaptive(blocks, lib, k, m=32, cap=4)
    assert (np.asarray(d_a) == np.asarray(d_o) + 1).all()
    # explicitly disabled even at forced-low threshold
    monkeypatch.setenv("EMOSAIC_AUDIT_ROWS", "1")
    monkeypatch.setenv("EMOSAIC_AUDIT", "0")
    d_a2, _ = distance.l1_topk_adaptive(blocks, lib, k, m=32, cap=4)
    assert (np.asarray(d_a2) == np.asarray(d_o) + 1).all()
    assert "EXACTNESS AUDIT" not in capsys.readouterr().err


def test_ad_proj_bank_guard_rejects_nondivisible():
    """ADVICE r4: a bank whose row count is not a multiple of 8 must
    error loudly instead of silently dropping tail rows."""
    import jax.numpy as jnp
    import pytest as _pytest

    from emosaic_tpu.ops import distance

    bf = jnp.zeros(12 * 4, jnp.uint8)  # 12 rows of d=4
    with _pytest.raises(ValueError, match="divisible by"):
        distance._ad_proj_bank_jit(bf, d=4, g=2, chan=False)


def test_analysis_validation_errors(rng):
    """Public-op input validation: shape, too-small grid, and the int32
    box-sum overflow guard (review r4) on both the host wrapper and the
    traceable core."""
    import jax.numpy as jnp

    from emosaic_tpu.ops.analysis import _analyse_batch_jit

    with pytest.raises(ValueError, match=r"expected \[T,h,w,3\]"):
        analyse_batch(np.zeros((2, 8, 8), np.uint8), dim=2)
    with pytest.raises(ValueError, match="smaller than"):
        analyse_batch(np.zeros((1, 3, 3, 3), np.uint8), dim=4)
    with pytest.raises(ValueError, match="per-channel sums exceed"):
        # a 2903^2 box is ~8.43M px: 255*8.43e6 > 2^31-1 wraps the int32
        # accumulator; the guard fires before any device work
        analyse_batch(np.zeros((1, 2903, 2903, 3), np.uint8), dim=1)
    # the traceable core repeats the same guards at trace time
    with pytest.raises(ValueError, match="smaller than"):
        _analyse_batch_jit(jnp.zeros((1, 3, 3, 3), jnp.uint8), dim=4)
    with pytest.raises(ValueError, match="per-channel sums exceed"):
        _analyse_batch_jit(jnp.zeros((1, 2903, 2903, 3), jnp.uint8), dim=1)


def test_source_blocks_validation_errors():
    with pytest.raises(ValueError, match=r"expected \[H,W,3\]"):
        source_blocks(np.zeros((8, 8), np.uint8), dim=2)
    with pytest.raises(ValueError, match="not divisible"):
        source_blocks(np.zeros((9, 8, 3), np.uint8), dim=2)


def test_flip_palettes_nonsquare_n():
    """Flip augmentation needs a square cell grid (utils.rs:18-43 mirrors
    rows of a dim x dim grid); a non-square N is a contract violation."""
    from emosaic_tpu.ops.distance import flip_palettes

    with pytest.raises(ValueError, match="perfect square"):
        flip_palettes(np.zeros((2, 2, 3), np.uint8))


def test_lut_validation_and_packed_entry(rng):
    """LUT build/match input contracts + the pre-packed index entry point
    matching the [B,3] entry bit-for-bit."""
    from emosaic_tpu.ops import lut as lutmod

    with pytest.raises(ValueError, match=r"requires \[L,3\]"):
        lutmod.build_l1_lut(np.zeros((4, 6), np.uint8))
    with pytest.raises(ValueError, match="empty library"):
        lutmod.build_l1_lut(np.zeros((0, 3), np.uint8))
    with pytest.raises(ValueError, match="LUT cap"):
        lutmod.build_l1_lut(np.zeros((lutmod.MAX_ROWS + 1, 3), np.uint8))

    lib = rng.integers(0, 256, size=(5, 3), dtype=np.uint8)
    lut = lutmod.build_l1_lut(lib)
    with pytest.raises(ValueError, match=r"requires \[B,3\]"):
        lutmod.lut_match(np.zeros((4, 4), np.uint8), lut)
    blocks = rng.integers(0, 256, size=(7, 3), dtype=np.uint8)
    d1, r1 = map(np.asarray, lutmod.lut_match(blocks, lut))
    d2, r2 = map(
        np.asarray, lutmod.lut_match_packed(lutmod.pack_rgb(blocks), lut)
    )
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(r1, r2)
