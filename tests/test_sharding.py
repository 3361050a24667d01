"""Mesh-sharding tests on the virtual 8-device CPU mesh: the sharded
kernels must be bit-identical to the single-chip ones (including the
lowest-row tie-break)."""

import math

import numpy as np
import pytest

import jax

from emosaic_tpu.ops.analysis import analyse_batch, source_blocks
from emosaic_tpu.ops.composite import compose_mosaic
from emosaic_tpu.ops.distance import build_library, l1_argmin_xla, rows_to_items
from emosaic_tpu.parallel import make_mesh, sharded_l1_argmin, sharded_mosaic_step


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_match_bit_identical(rng, devices, data, model):
    mesh = make_mesh(8, model=model)
    pal = rng.integers(0, 256, size=(97, 4, 3), dtype=np.uint8)
    lib = np.array(build_library(pal))  # 194 rows, not divisible: pads
    blocks = rng.integers(0, 256, size=(131, 12), dtype=np.uint8)
    # duplicate palettes to force cross-shard ties
    lib[50] = lib[3]
    blocks[7] = lib[3]
    d_ref, r_ref = l1_argmin_xla(blocks, lib)
    d_sh, r_sh = sharded_l1_argmin(blocks, lib, mesh)
    assert (np.asarray(d_sh) == np.asarray(d_ref)).all()
    assert (np.asarray(r_sh) == np.asarray(r_ref)).all()


def test_sharded_mosaic_step_matches_single_chip(rng, devices):
    mesh = make_mesh(8, model=2)
    dim, ts = 2, 4
    t = 32  # divisible by model=2
    tiles = rng.integers(0, 256, size=(t, ts, ts, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(16, 12, 3), dtype=np.uint8)  # 8x6 blocks
    out = np.asarray(sharded_mosaic_step(tiles, src, mesh, dim, ts))
    assert out.shape == (8 * ts, 6 * ts, 3)

    # single-chip reference pipeline
    pal = np.asarray(analyse_batch(tiles, dim))
    lib = np.asarray(build_library(pal))
    blocks = np.asarray(source_blocks(src, dim))
    _, rows = l1_argmin_xla(blocks, lib)
    items = np.asarray(rows_to_items(rows, t)).reshape(8, 6)
    ref = np.asarray(compose_mosaic(items, tiles))
    assert (out == ref).all()


@pytest.mark.parametrize("n", [8, 4])
def test_ring_rotation_matcher_bit_identical(rng, devices, n):
    # SURVEY §2.6 CP analogue: library shards rotate around the ring
    from emosaic_tpu.parallel import sharded_l1_argmin_ring

    mesh = make_mesh(n, model=1)
    pal = rng.integers(0, 256, size=(53, 1, 3), dtype=np.uint8)
    lib = np.array(build_library(pal))
    blocks = rng.integers(0, 256, size=(77, 3), dtype=np.uint8)
    lib[30] = lib[2]  # cross-shard tie
    blocks[5] = lib[2]
    d_ref, r_ref = l1_argmin_xla(blocks, lib)
    d_rg, r_rg = sharded_l1_argmin_ring(blocks, lib, mesh)
    assert (np.asarray(d_rg) == np.asarray(d_ref)).all()
    assert (np.asarray(r_rg) == np.asarray(r_ref)).all()


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (1, 8)])
def test_sharded_topk_bit_identical(rng, devices, data, model):
    # multi-chip no-repeat scorer: per-shard stripe top-k merged by all-gather
    # must equal the single-chip stripes, including cross-shard ties and
    # k > L padding
    from emosaic_tpu.ops.distance import l1_topk_stripes
    from emosaic_tpu.parallel import sharded_l1_topk

    mesh = make_mesh(8, model=model)
    pal = rng.integers(0, 256, size=(45, 4, 3), dtype=np.uint8)
    lib = np.array(build_library(pal))  # 90 rows -> padded per shard
    lib[60] = lib[2]  # cross-shard tie
    blocks = rng.integers(0, 256, size=(53, 12), dtype=np.uint8)
    blocks[11] = lib[2]
    d_ref, r_ref = l1_topk_stripes(blocks, lib, 7)
    d_sh, r_sh = sharded_l1_topk(blocks, lib, 7, mesh)
    assert (d_sh == d_ref).all()
    assert (r_sh == r_ref).all()
    # k > L padding convention
    small = lib[:5]
    d_ref2, r_ref2 = l1_topk_stripes(blocks, small, 9)
    d_sh2, r_sh2 = sharded_l1_topk(blocks, small, 9, mesh)
    assert (d_sh2 == d_ref2).all()
    assert (r_sh2 == r_ref2).all()


@pytest.mark.parametrize("n", [8, 4, 2, 1])
def test_sharded_lut_build_bit_identical(rng, devices, n):
    # the chamfer LUT build sharded over the lattice b axis
    # (parallel-prefix carries across devices) must equal the single-chip build
    # bit-for-bit, including lowest-row ties from duplicated colors.
    from emosaic_tpu.ops.lut import build_l1_lut
    from emosaic_tpu.parallel import sharded_build_l1_lut

    mesh = make_mesh(n, model=1)
    lib = rng.integers(0, 256, size=(300, 3), dtype=np.uint8)
    lib[250] = lib[7]  # duplicate color -> tie, lowest row must win
    lib[299] = lib[0]
    ref = np.asarray(jax.device_get(build_l1_lut(lib)))
    sh = sharded_build_l1_lut(lib, mesh)
    assert (sh == ref).all()


def test_sharded_mosaic_step_model4(rng, devices):
    mesh = make_mesh(8, model=4)
    dim, ts = 1, 4
    tiles = rng.integers(0, 256, size=(16, ts, ts, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(4, 6, 3), dtype=np.uint8)  # 4x6 blocks
    out = np.asarray(sharded_mosaic_step(tiles, src, mesh, dim, ts))
    pal = np.asarray(analyse_batch(tiles, dim))
    lib = np.asarray(build_library(pal))
    blocks = np.asarray(source_blocks(src, dim))
    _, rows = l1_argmin_xla(blocks, lib)
    items = np.asarray(rows_to_items(rows, 16)).reshape(4, 6)
    ref = np.asarray(compose_mosaic(items, tiles))
    assert (out == ref).all()


def _mesh_cli_case(tmp_path, rng, extra, out_name_a, out_name_b):
    """Run the CLI twice (--mesh off vs --mesh 4x2) and return both
    decoded outputs. Uses a fresh tiles dir per case so analysis caches
    don't interact."""
    from PIL import Image

    from emosaic_tpu.cli import main

    tiles = tmp_path / "tiles"
    tiles.mkdir()
    for i in range(14):
        arr = rng.integers(0, 256, size=(20, 20, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tiles / f"t{i}.jpg", quality=95)
    src = rng.integers(0, 256, size=(8, 10, 3), dtype=np.uint8)
    Image.fromarray(src).save(tmp_path / "s.png")
    common = ["-s", "8", str(tmp_path / "s.png"), "mosaic", str(tiles)]
    main(["-o", str(tmp_path / out_name_a)] + common + extra + ["--mesh", "off"])
    main(["-o", str(tmp_path / out_name_b)] + common + extra + ["--mesh", "4x2"])
    a = np.asarray(Image.open(tmp_path / out_name_a).convert("RGB"))
    b = np.asarray(Image.open(tmp_path / out_name_b).convert("RGB"))
    return a, b


@pytest.mark.parametrize(
    "extra",
    [
        ["-m", "2"],  # dense exact match -> sharded_l1_argmin
        ["-m", "2", "--no-repeat"],  # global greedy -> sharded_l1_topk
        ["-m", "2", "--randomize", "25", "--seed", "7"],  # top-k prefix
        ["-m", "1"],  # mode 1 small: LUT ineligible at this size either way
    ],
)
def test_cli_mesh_output_identical(tmp_path, rng, devices, monkeypatch, extra):
    """--mesh 4x2 must be pixel-identical to single-device for every
    matcher family it covers (the product-surface wiring, not just the
    kernels)."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.chdir(tmp_path)
    a, b = _mesh_cli_case(tmp_path, rng, extra, "a.png", "b.png")
    assert (a == b).all()


def test_cli_mesh_too_many_devices(tmp_path, rng, devices, monkeypatch, capsys):
    from PIL import Image

    from emosaic_tpu.cli import main

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    tiles = tmp_path / "tiles"
    tiles.mkdir()
    Image.fromarray(
        rng.integers(0, 256, size=(20, 20, 3), dtype=np.uint8)
    ).save(tiles / "t0.jpg", quality=95)
    Image.fromarray(
        rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    ).save(tmp_path / "s.png")
    with pytest.raises(SystemExit):
        main(
            ["-o", str(tmp_path / "x.png"), "-s", "8", str(tmp_path / "s.png"),
             "mosaic", str(tiles), "--mesh", "64"]
        )


@pytest.mark.parametrize(
    "data,model,b",
    [
        (8, 1, 520),  # per-shard rows strictly between 64 and 128: the
        # bc2-divisibility regime that once crashed the rescore reshape
        (4, 2, 37),
        (2, 4, 1024),  # bc = 128 branch (b >= 128 * n_dev)
    ],
)
def test_sharded_adaptive_topk_bit_identical(rng, devices, data, model, b):
    """The block-sharded adaptive scorer must equal the single-device
    adaptive scorer (itself l1_topk-exact) on clusterable data, and route
    concentrated data to the exact sharded stripes.

    The library must clear the eligibility gate (nseg * cap >= m + 1
    with the production m=1024 needs l >= ~8300 rows), otherwise the
    call silently degrades to sharded_l1_topk and tests nothing — a gap
    a round-3 review caught hiding a real crash."""
    from emosaic_tpu.ops import distance as dd
    from emosaic_tpu.ops.distance import l1_topk_adaptive, l1_topk_stripes
    from emosaic_tpu.parallel import sharded_l1_topk_adaptive

    mesh = make_mesh(8, model=model)
    d, l, k = 48, 9000, 4
    # the shapes must actually take the sharded adaptive path
    nseg = -(-l // dd._TL_SEG)
    assert dd._AD_M + 1 <= nseg * dd._AD_CAP and l > 2 * dd._AD_M
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
    blocks[5] = lib[7]  # exact hit + duplicate-row ties in the library
    lib[100] = lib[7]
    d_ref, r_ref = l1_topk_adaptive(blocks, lib, k)
    d_sh, r_sh = sharded_l1_topk_adaptive(blocks, lib, k, mesh)
    # both are l1_topk-exact; compare against the stripes oracle too
    d_o, r_o = l1_topk_stripes(blocks, lib, k)
    assert (np.asarray(d_ref) == np.asarray(d_o)).all()
    assert (d_sh == np.asarray(d_o)).all()
    assert (r_sh == np.asarray(r_o)).all()


def test_sharded_adaptive_topk_banked_library(rng, devices, monkeypatch):
    """With the DMA addressing limit forced small, the replicated library
    splits into banks (distance._lib_banks) and the sharded scorer must
    stay exact — the banked tuple rides shard_map's replicated in_spec."""
    from emosaic_tpu.ops import distance as dd
    from emosaic_tpu.ops.distance import l1_topk_stripes
    from emosaic_tpu.parallel import sharded_l1_topk_adaptive

    mesh = make_mesh(8, model=2)
    d, l, k = 48, 9000, 4
    monkeypatch.setattr(dd, "_DMA_LIB_BYTES_MAX", 4096 * d)
    assert len(dd._lib_banks(np.zeros((9088, d), np.uint8), d)) == 3
    bases = rng.integers(0, 256, size=(50, d))
    lib = np.clip(
        np.repeat(bases, l // 50, axis=0) + rng.integers(-5, 6, size=(l, d)),
        0,
        255,
    ).astype(np.uint8)
    blocks = np.clip(
        lib[rng.integers(0, l, size=64)].astype(np.int32)
        + rng.integers(-3, 4, size=(64, d)),
        0,
        255,
    ).astype(np.uint8)
    d_sh, r_sh = sharded_l1_topk_adaptive(blocks, lib, k, mesh)
    d_o, r_o = l1_topk_stripes(blocks, lib, k)
    assert (d_sh == np.asarray(d_o)).all()
    assert (r_sh == np.asarray(r_o)).all()


def test_sharded_adaptive_topk_concentrated_reroutes(rng, devices, monkeypatch):
    # concentrated (uniform-random) data: the SAMPLE gate (not the
    # eligibility gate — the library is adaptive-eligible) must reroute
    # to the exact sharded stripes. Assert the reroute actually HAPPENS
    # (exactness alone would also hold via per-row fallback repair,
    # making the routing claim vacuous).
    from emosaic_tpu.ops.distance import l1_topk_stripes
    from emosaic_tpu.parallel import sharded as sh

    mesh = make_mesh(8, model=2)
    d, l, k = 48, 9000, 4
    rerouted = []
    real = sh.sharded_l1_topk

    def spy(*a, **kw):
        rerouted.append(True)
        return real(*a, **kw)

    monkeypatch.setattr(sh, "sharded_l1_topk", spy)
    blocks_u = rng.integers(0, 256, size=(19, d), dtype=np.uint8)
    lib_u = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    d_u, r_u = sh.sharded_l1_topk_adaptive(blocks_u, lib_u, k, mesh)
    assert rerouted, "sample gate did not reroute concentrated data"
    d_uo, r_uo = l1_topk_stripes(blocks_u, lib_u, k)
    assert (d_u == np.asarray(d_uo)).all()
    assert (r_u == np.asarray(r_uo)).all()


def test_sharded_adaptive_topk_multi_slice(rng, devices, monkeypatch):
    """Force multiple block slices through the sharded scorer (join +
    smaller tail shape) and require bit-equality with the oracle."""
    from emosaic_tpu.ops import distance as dd
    from emosaic_tpu.ops.distance import l1_topk_stripes
    from emosaic_tpu.parallel import sharded_l1_topk_adaptive

    monkeypatch.setattr(dd, "_AD_B_SLICE", 16)  # slice = 16*8 = 128 rows
    mesh = make_mesh(8, model=1)
    d, l, k, b = 48, 9000, 4, 300  # bc=8, unit=64 -> bp=320: 128+128+64
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
    d_sh, r_sh = sharded_l1_topk_adaptive(blocks, lib, k, mesh)
    d_o, r_o = l1_topk_stripes(blocks, lib, k)
    assert (d_sh == np.asarray(d_o)).all()
    assert (r_sh == np.asarray(r_o)).all()


def test_sharded_adaptive_oversized_library_streams(rng, devices, monkeypatch):
    """Past the device-resident budget the sharded scorer streams host
    banks, each bank scored by the SAME mesh-sharded scorer (bank
    streaming composes with block sharding) — bit-identical to the
    stripes oracle, duplicate-row ties included."""
    from emosaic_tpu.ops import distance as dd
    from emosaic_tpu.ops.distance import l1_topk_stripes
    from emosaic_tpu.parallel import sharded_l1_topk_adaptive

    mesh = make_mesh(8)
    d, l, k = 48, 9000, 4
    bases = rng.integers(0, 256, size=(50, d))
    lib = np.clip(
        np.repeat(bases, l // 50, axis=0) + rng.integers(-5, 6, size=(l, d)),
        0,
        255,
    ).astype(np.uint8)
    blocks = np.clip(
        lib[rng.integers(0, l, size=64)].astype(np.int32)
        + rng.integers(-3, 4, size=(64, d)),
        0,
        255,
    ).astype(np.uint8)
    blocks[5] = lib[7]
    lib[100] = lib[7]
    # budget of 4096 rows' worth -> three banks (4096, 4096, 808); the
    # per-bank sharded calls stay under the gate (no re-entry)
    monkeypatch.setattr(dd, "_DEVICE_LIB_BYTES_MAX", 4096 * d)
    d_sh, r_sh = sharded_l1_topk_adaptive(blocks, lib, k, mesh)
    d_o, r_o = l1_topk_stripes(blocks, lib, k)
    assert (d_sh == np.asarray(d_o)).all()
    assert (r_sh == np.asarray(r_o)).all()


def test_sharded_argmin_topk_oversized_per_shard_streams(rng, devices, monkeypatch):
    """All three library-sharding kernels (argmin all-gather, argmin
    ring, top-k) must stream host banks through THEMSELVES when the
    per-shard library share exceeds the device budget — bit-identical
    to the single-chip oracles, ties included."""
    from emosaic_tpu.ops import distance as dd
    from emosaic_tpu.ops.distance import l1_argmin_xla, l1_topk_stripes
    from emosaic_tpu.parallel import (
        sharded_l1_argmin,
        sharded_l1_argmin_ring,
        sharded_l1_topk,
    )

    mesh = make_mesh(8, model=2)
    l, d, k = 2000, 12, 5
    lib = (rng.integers(0, 3, size=(l, d)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(40, d)) * 16).astype(np.uint8)
    d_o, r_o = l1_argmin_xla(blocks, lib)
    d_t, r_t = l1_topk_stripes(blocks, lib, k)
    # per-"model"-shard share (l/2 rows) over budget -> banks of 256 rows
    monkeypatch.setattr(dd, "_DEVICE_LIB_BYTES_MAX", 256 * d)
    d_a, r_a = sharded_l1_argmin(blocks, lib, mesh)
    np.testing.assert_array_equal(np.asarray(d_a), np.asarray(d_o))
    np.testing.assert_array_equal(np.asarray(r_a), np.asarray(r_o))
    d_r, r_r = sharded_l1_argmin_ring(blocks, lib, mesh)
    np.testing.assert_array_equal(np.asarray(d_r), np.asarray(d_o))
    np.testing.assert_array_equal(np.asarray(r_r), np.asarray(r_o))
    d_k, r_k = sharded_l1_topk(blocks, lib, k, mesh)
    np.testing.assert_array_equal(np.asarray(d_k), np.asarray(d_t))
    np.testing.assert_array_equal(np.asarray(r_k), np.asarray(r_t))


def test_sharded_prepared_library_bit_identical(rng, devices):
    """A pre-uploaded library handle (the streamed scorer's prefetch)
    must give bit-identical results to the internal upload on every
    library-sharding kernel, and a handle for a DIFFERENT library shape
    is refused."""
    import emosaic_tpu.parallel.sharded as sh
    from emosaic_tpu.parallel import (
        sharded_l1_argmin,
        sharded_l1_argmin_ring,
        sharded_l1_topk,
    )

    mesh = make_mesh(8, model=2)
    l, d, k = 500, 12, 5
    lib = (rng.integers(0, 3, size=(l, d)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(24, d)) * 16).astype(np.uint8)
    prep2 = sh._pad_prepare(2)(lib, d)
    prep8 = sh._pad_prepare(8)(lib, d)
    d0, r0 = sharded_l1_topk(blocks, lib, k, mesh)
    d1, r1 = sharded_l1_topk(blocks, lib, k, mesh, prepared=prep2)
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(r1, r0)
    da0, ra0 = sharded_l1_argmin(blocks, lib, mesh)
    da1, ra1 = sharded_l1_argmin(blocks, lib, mesh, prepared=prep2)
    np.testing.assert_array_equal(np.asarray(da1), np.asarray(da0))
    np.testing.assert_array_equal(np.asarray(ra1), np.asarray(ra0))
    dr0, rr0 = sharded_l1_argmin_ring(blocks, lib, mesh)
    dr1, rr1 = sharded_l1_argmin_ring(blocks, lib, mesh, prepared=prep8)
    np.testing.assert_array_equal(np.asarray(dr1), np.asarray(dr0))
    np.testing.assert_array_equal(np.asarray(rr1), np.asarray(rr0))
    with pytest.raises(ValueError, match="prepared library"):
        sharded_l1_topk(blocks, lib[: l - 100], k, mesh, prepared=prep2)


def test_sharded_adaptive_prepared_banks_bit_identical(rng, devices):
    """The mesh-sharded adaptive scorer must accept the same
    `_ad_prepare` bank-tuple handle as the single-chip scorer (its jit
    replicates it at dispatch) with bit-identical results, and refuse a
    mismatched handle."""
    from emosaic_tpu.ops import distance as dd
    from emosaic_tpu.parallel import sharded_l1_topk_adaptive

    mesh = make_mesh(8)
    d, l, k = 48, 9000, 4
    bases = rng.integers(0, 256, size=(50, d))
    lib = np.clip(
        np.repeat(bases, l // 50, axis=0) + rng.integers(-5, 6, size=(l, d)),
        0,
        255,
    ).astype(np.uint8)
    blocks = np.clip(
        lib[rng.integers(0, l, size=64)].astype(np.int32)
        + rng.integers(-3, 4, size=(64, d)),
        0,
        255,
    ).astype(np.uint8)
    handle = dd._ad_prepare(lib, d)
    d0, r0 = sharded_l1_topk_adaptive(blocks, lib, k, mesh)
    d1, r1 = sharded_l1_topk_adaptive(blocks, lib, k, mesh, prepared=handle)
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(r1, r0)
    with pytest.raises(ValueError, match="prepared banks"):
        sharded_l1_topk_adaptive(
            blocks, lib[: l - 500], k, mesh, prepared=handle
        )


def test_sharded_streamed_prefetch_delivers_handles(rng, devices, monkeypatch):
    """The oversized-library gates' bank scorers expose `prepare`, so the
    streamer's worker thread prefetches every bank's padded upload;
    results stay bit-identical to the single-chip oracle."""
    import emosaic_tpu.parallel.sharded as sh
    from emosaic_tpu.ops import distance as dd
    from emosaic_tpu.ops.distance import l1_topk_stripes
    from emosaic_tpu.parallel import sharded_l1_topk

    mesh = make_mesh(8, model=2)
    l, d, k = 2000, 12, 5
    lib = (rng.integers(0, 3, size=(l, d)) * 16).astype(np.uint8)
    blocks = (rng.integers(0, 3, size=(40, d)) * 16).astype(np.uint8)
    d_t, r_t = l1_topk_stripes(blocks, lib, k)
    prepared_rows = []
    real_pp = sh._pad_prepare

    def spy_pp(mult):
        inner = real_pp(mult)

        def wrapped(ll, *a, **kw):
            prepared_rows.append(ll.shape[0])
            return inner(ll, *a, **kw)

        return wrapped

    monkeypatch.setattr(sh, "_pad_prepare", spy_pp)
    monkeypatch.setattr(dd, "_DEVICE_LIB_BYTES_MAX", 256 * d)
    d_k, r_k = sharded_l1_topk(blocks, lib, k, mesh)
    assert prepared_rows and sum(prepared_rows) == l  # every bank prefetched
    np.testing.assert_array_equal(np.asarray(d_k), np.asarray(d_t))
    np.testing.assert_array_equal(np.asarray(r_k), np.asarray(r_t))


def test_sharded_jits_are_cached_across_calls(rng, devices):
    """review r4: the mesh-sharded jits were per-call closures, so the
    streamed bank route recompiled an identical program per ~4 GiB bank.
    Same mesh + shapes must reuse the cached PjitFunction."""
    from emosaic_tpu.parallel import sharded as sh

    mesh = make_mesh(8, model=2)
    blocks = rng.integers(0, 256, size=(16, 12), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(64, 12), dtype=np.uint8)
    sh._topk_run_jit.cache_clear()
    from emosaic_tpu.parallel import sharded_l1_topk

    sharded_l1_topk(blocks, lib, 3, mesh)
    sharded_l1_topk(blocks, lib, 3, mesh)
    info = sh._topk_run_jit.cache_info()
    assert info.misses == 1 and info.hits >= 1, info


def test_sharded_validation_errors(rng):
    """Mesh/shape contracts fail loudly: model must divide the device
    count, the LUT lattice axis must split evenly, and the fused mosaic
    step requires divisible tile/block counts."""
    from emosaic_tpu.parallel.lut import sharded_build_l1_lut

    with pytest.raises(ValueError, match="not divisible by model"):
        make_mesh(8, model=3)

    mesh6 = make_mesh(6, model=1)  # 256 % 6 != 0
    with pytest.raises(ValueError, match="not divisible by 6 devices"):
        sharded_build_l1_lut(np.zeros((4, 3), np.uint8), mesh6)
    mesh8 = make_mesh(8, model=2)
    with pytest.raises(ValueError, match=r"requires \[L,3\]"):
        sharded_build_l1_lut(np.zeros((4, 6), np.uint8), mesh8)
    with pytest.raises(ValueError, match="out of range"):
        sharded_build_l1_lut(np.zeros((0, 3), np.uint8), mesh8)

    tiles = rng.integers(0, 256, size=(3, 8, 8, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    with pytest.raises(ValueError, match="not divisible by model"):
        sharded_mosaic_step(tiles, src, mesh8, 2, 8)  # T=3, model=2
    tiles4 = rng.integers(0, 256, size=(4, 8, 8, 3), dtype=np.uint8)
    src_odd = rng.integers(0, 256, size=(6, 8, 3), dtype=np.uint8)
    with pytest.raises(ValueError, match="block rows"):
        sharded_mosaic_step(tiles4, src_odd, mesh8, 2, 8)  # nby=3, data=4


def test_ring_argmin_streams_beyond_budget(rng, monkeypatch):
    """A library whose per-ring shard exceeds the device-resident budget
    streams host banks through the SAME ring kernel, bit-identical to
    the single-chip argmin (lowest-row ties preserved cross-bank)."""
    from emosaic_tpu.ops import distance as dd
    from emosaic_tpu.parallel import sharded_l1_argmin_ring

    blocks = rng.integers(0, 256, size=(16, 3), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(600, 3), dtype=np.uint8)
    mesh = make_mesh(8, model=1)
    d0, r0 = map(np.asarray, dd.l1_argmin_xla(blocks, lib))
    monkeypatch.setattr(dd, "_DEVICE_LIB_BYTES_MAX", 16)
    d1, r1 = sharded_l1_argmin_ring(blocks, lib, mesh)
    np.testing.assert_array_equal(np.asarray(d1), d0)
    np.testing.assert_array_equal(np.asarray(r1), r0)


def test_sharded_stripes_i32_form_bit_identical(rng, monkeypatch):
    """Beyond the f32-lane byte budget the per-shard stripe switches to
    i32 lanes; both forms are exact for u8 operands — bit-identical."""
    from emosaic_tpu.ops import distance as dd

    blocks = rng.integers(0, 256, size=(16, 12), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(64, 12), dtype=np.uint8)
    mesh = make_mesh(8, model=2)
    d0, r0 = map(np.asarray, dd.l1_argmin_xla(blocks, lib))
    monkeypatch.setattr(dd, "_STRIPE_F32_MAX_BYTES", 0)
    d1, r1 = map(np.asarray, sharded_l1_argmin(blocks, lib, mesh))
    np.testing.assert_array_equal(d1, d0)
    np.testing.assert_array_equal(r1, r0)
