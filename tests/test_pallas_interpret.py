"""CPU coverage of the Pallas-Triton argmin kernel's body via interpret
mode, and of the library-bank helpers the XLA scorers share.

On CPU the production dispatcher routes to the XLA scan, so without these
tests a regression in `_l1_triton_kernel` would leave the suite green.
`pl.pallas_call(interpret=True)` executes the kernel through the Pallas
interpreter. Oracles: the pure-XLA scan (itself parity-tested against the
reference semantics, tests/test_render.py B/W universe, mod.rs:83-161)
and a host int64 brute force.
"""

import numpy as np
import pytest

from emosaic_tpu.ops import backend, distance


def _brute(blocks, lib):
    full = np.abs(
        blocks.astype(np.int64)[:, None, :] - lib.astype(np.int64)[None]
    ).sum(-1)
    return full.min(1), full.argmin(1)  # argmin: first (lowest) row


@pytest.mark.parametrize(
    "b,l,d",
    [
        (1, 3, 3),  # tiny, heavy padding on every axis
        (5, 700, 12),  # l crosses several library tiles
        (300, 513, 12),  # b crosses several block tiles; ragged l
        (70, 100, 200),  # high d, ragged library
    ],
)
def test_l1_argmin_pallas_interpret_matches_xla(rng, b, l, d):
    blocks = rng.integers(0, 256, size=(b, d), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    dist_p, row_p = distance.l1_argmin_triton(blocks, lib, interpret=True)
    dist_x, row_x = distance.l1_argmin_xla(blocks, lib)
    np.testing.assert_array_equal(np.asarray(dist_p), np.asarray(dist_x))
    np.testing.assert_array_equal(np.asarray(row_p), np.asarray(row_x))


def test_l1_argmin_pallas_interpret_tie_break_lowest_row(rng):
    # duplicate rows force exact ties; the contract is lowest-row-wins
    # (ops/distance.py module docstring; SURVEY.md section 6)
    d = 12
    base = rng.integers(0, 256, size=(40, d), dtype=np.uint8)
    lib = np.concatenate([base, base, base], axis=0)  # every row tied x3
    blocks = base[rng.integers(0, 40, size=17)]
    dist_p, row_p = distance.l1_argmin_triton(blocks, lib, interpret=True)
    assert np.all(np.asarray(dist_p) == 0)
    assert np.all(np.asarray(row_p) < 40)
    dist_x, row_x = distance.l1_argmin_xla(blocks, lib)
    np.testing.assert_array_equal(np.asarray(row_p), np.asarray(row_x))


@pytest.mark.parametrize("d", [12, 27, 48, 75, 108, 192, 256])
def test_triton_interpret_feature_dims(rng, d):
    """Every matched mode's feature dim up to the kernel's ceiling, with
    ragged B and L (neither a multiple of the tile)."""
    blocks = rng.integers(0, 256, size=(67, d), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(203, d), dtype=np.uint8)
    dist, row = distance.l1_argmin_triton(blocks, lib, interpret=True)
    ref_d, ref_r = _brute(blocks, lib)
    np.testing.assert_array_equal(np.asarray(dist), ref_d)
    np.testing.assert_array_equal(np.asarray(row), ref_r)


def test_triton_interpret_single_block(rng):
    blocks = rng.integers(0, 256, size=(1, 48), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(150, 48), dtype=np.uint8)
    dist, row = distance.l1_argmin_triton(blocks, lib, interpret=True)
    ref_d, ref_r = _brute(blocks, lib)
    assert np.asarray(dist).shape == (1,)
    np.testing.assert_array_equal(np.asarray(dist), ref_d)
    np.testing.assert_array_equal(np.asarray(row), ref_r)


def test_triton_interpret_library_smaller_than_tile(rng):
    # 5 rows in a 64-column tile: the padding columns must never win,
    # even against the worst possible real distance
    blocks = np.full((9, 12), 255, np.uint8)
    lib = np.zeros((5, 12), np.uint8)
    dist, row = distance.l1_argmin_triton(blocks, lib, interpret=True)
    assert (np.asarray(dist) == 255 * 12).all()
    assert (np.asarray(row) == 0).all()


def test_triton_interpret_all_tied_library(rng):
    # every library row identical: row 0 wins for every block, across
    # tiles and across library splits
    lib = np.repeat(rng.integers(0, 256, size=(1, 27), dtype=np.uint8), 700, 0)
    blocks = rng.integers(0, 256, size=(33, 27), dtype=np.uint8)
    assert distance._triton_splits(33, 700, 16, 16) > 1
    dist, row = distance.l1_argmin_triton(
        blocks, lib, interpret=True, bm=16, bn=16
    )
    ref_d, _ = _brute(blocks, lib)
    np.testing.assert_array_equal(np.asarray(dist), ref_d)
    assert (np.asarray(row) == 0).all()


def test_triton_interpret_ties_across_splits(rng):
    """A tie between rows in different library splits resolves to the
    lower row: the split combine is a first-occurrence argmin."""
    d = 12
    lib = rng.integers(0, 256, size=(512, d), dtype=np.uint8)
    lib[300] = lib[40]  # same row in a later split
    blocks = lib[[40, 300, 7]]
    dist, row = distance.l1_argmin_triton(
        blocks, lib, interpret=True, bm=16, bn=16
    )
    np.testing.assert_array_equal(np.asarray(row), [40, 40, 7])
    np.testing.assert_array_equal(np.asarray(dist), [0, 0, 0])


def test_triton_rejects_wide_features(rng):
    d = backend.TRITON_MAX_D + 3
    x = np.zeros((2, d), np.uint8)
    with pytest.raises(ValueError, match="D <="):
        distance.l1_argmin_triton(x, x, interpret=True)


def test_triton_span_matches_padded_operands():
    """`_triton_span` is the larger padded operand's element count, as the
    jit pads it: blocks to whole row tiles, the library to splits x
    tiles x bn columns."""
    bm, bn = distance._TRITON_BM, distance._TRITON_BN
    b, l, d = 16384, 65534, 192
    splits = distance._triton_splits(b, l, bm, bn)
    lp = -(-(-(-l // bn)) // splits) * splits * bn
    assert lp >= l and distance._triton_span(b, l, d) == d * lp
    assert distance._triton_span(1000, 10, 12) == 12 * 1024  # blocks larger


def test_triton_rejects_operands_past_32bit_offsets(monkeypatch, rng):
    """Inputs whose flat offsets would pass the kernel's 32-bit index are
    refused before any kernel runs (limit lowered to a test size)."""
    x = rng.integers(0, 256, size=(40, 12), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(300, 12), dtype=np.uint8)
    span = distance._triton_span(40, 300, 12, 16, 16)
    monkeypatch.setattr(backend, "TRITON_INDEX_LIMIT", span)
    with pytest.raises(ValueError, match="32-bit"):
        distance.l1_argmin_triton(x, lib, interpret=True, bm=16, bn=16)
    monkeypatch.setattr(backend, "TRITON_INDEX_LIMIT", span + 1)
    dist, row = distance.l1_argmin_triton(x, lib, interpret=True, bm=16, bn=16)
    ref_d, ref_r = _brute(x, lib)
    np.testing.assert_array_equal(np.asarray(dist), ref_d)
    np.testing.assert_array_equal(np.asarray(row), ref_r)


def test_triton_splits_fill_the_grid():
    """Enough library splits to reach the program target, never more
    splits than library tiles, at least one."""
    bm, bn = distance._TRITON_BM, distance._TRITON_BN
    s = distance._triton_splits(16384, 65534, bm, bn)
    assert (16384 // bm) * s <= distance._TRITON_PROGRAMS
    assert s >= distance._TRITON_PROGRAMS // (16384 // bm)
    assert distance._triton_splits(1, 10, bm, bn) == 1
    assert distance._triton_splits(10**6, 65534, bm, bn) == 1


def test_dma_bank_rows_boundary_math():
    """_dma_bank_rows picks the largest power-of-two row count whose bank
    stays within the addressing limit: rb*dp <= LIMIT < 2*rb*dp. At the
    flagship D=3072 this is exactly 2^20 rows (a 3 GiB bank, matching the
    measured-exact 1M-row single-buffer run), and a bank may land exactly
    AT the 4 GiB limit (row rb-1's byte offset is LIMIT - dp < 2^32)."""
    limit = distance._DMA_LIB_BYTES_MAX
    for dp in (3072, 1024, 2048, 49152, 768):
        rb = distance._dma_bank_rows(dp)
        assert rb & (rb - 1) == 0
        assert rb * dp <= limit < 2 * rb * dp
    assert distance._dma_bank_rows(3072) == 1 << 20
    # power-of-two dp fills the limit exactly — allowed (offsets < 2^32)
    assert distance._dma_bank_rows(1024) * 1024 == limit


def test_lib_banks_split_and_reassemble(monkeypatch, rng):
    """_lib_banks honors the byte ceiling: power-of-two full banks whose
    rows stay multiples of 128, a smaller last bank, exact content; and a
    single bank (the proven path) below the limit."""
    d = 48
    lp = 128 * 7
    lib = rng.integers(0, 256, size=(lp, d), dtype=np.uint8)
    one = distance._lib_banks(lib, d)
    assert len(one) == 1 and one[0].size == lp * d
    monkeypatch.setattr(distance, "_DMA_LIB_BYTES_MAX", 2 * 128 * d)
    banks = distance._lib_banks(lib, d)
    assert [bf.size // d for bf in banks] == [256, 256, 256, 128]
    joined = np.concatenate([np.asarray(bf).reshape(-1, d) for bf in banks])
    np.testing.assert_array_equal(joined, lib)


def test_ad_scorer_banked_library_bit_identical(rng):
    """The adaptive-scorer jits accept the banked library tuple and must
    produce bit-identical (dists, rows, ok) to the single-flat form (the
    gather rescore path; the DMA path's bank parity is pinned above)."""
    import jax.numpy as jnp

    b, l, d, g, cap, m, k = 16, 2000, 48, 4, 4, 32, 6
    lp = -(-l // 128) * 128  # 2048 -> two 1024-row banks
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = lib[rng.integers(0, l, size=b)]
    lib_pad = np.zeros((lp, d), np.uint8)
    lib_pad[:l] = lib
    bf = jnp.asarray(blocks.reshape(-1))
    lf = jnp.asarray(lib_pad.reshape(-1))
    lf2 = (
        jnp.asarray(lib_pad[:1024].reshape(-1)),
        jnp.asarray(lib_pad[1024:].reshape(-1)),
    )
    outs = []
    for lib_arg in (lf, lf2):
        vals, cols, s_min = distance._ad_coarse_jit(
            bf, lib_arg, d=d, g=g, chan=True, bc=8, cap=cap, real_l=l
        )
        outs.append(
            distance._ad_rescore_jit(
                bf, vals, cols, s_min, lib_arg,
                d=d, bc=8, m=m, k=k, real_l=l,
            )
        )
    for a, bb in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(bb))


def test_ad_scorer_ragged_banks_bit_identical(monkeypatch, rng):
    """Same bit-identity with a RAGGED `_lib_banks` split (full
    power-of-two banks + a smaller last) — the shape class the 2M-row
    library produces ([2^20, 951424] rows at D=3072); the coarse
    projection's per-bank 8-way chunking must handle the short bank."""
    import jax.numpy as jnp

    b, l, d, g, cap, m, k = 16, 2250, 48, 4, 4, 32, 6
    lp = -(-l // 128) * 128  # 2304
    lib = rng.integers(0, 256, size=(l, d), dtype=np.uint8)
    blocks = lib[rng.integers(0, l, size=b)]
    lib_pad = np.zeros((lp, d), np.uint8)
    lib_pad[:l] = lib
    bf = jnp.asarray(blocks.reshape(-1))
    lf = jnp.asarray(lib_pad.reshape(-1))
    monkeypatch.setattr(distance, "_DMA_LIB_BYTES_MAX", 50_000)
    banks = distance._lib_banks(lib_pad, d)  # rb=1024 -> [1024, 1024, 256]
    assert [bk.size // d for bk in banks] == [1024, 1024, 256]
    outs = []
    for lib_arg in (lf, banks):
        vals, cols, s_min = distance._ad_coarse_jit(
            bf, lib_arg, d=d, g=g, chan=True, bc=8, cap=cap, real_l=l
        )
        outs.append(
            distance._ad_rescore_jit(
                bf, vals, cols, s_min, lib_arg,
                d=d, bc=8, m=m, k=k, real_l=l,
            )
        )
    for a, bb in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(bb))
