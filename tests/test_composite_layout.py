"""The unpadded composite layout against a host numpy composite, and the
seeded synthetic data the chip smoke test renders."""

import numpy as np
import pytest

from emosaic_tpu import synth
from emosaic_tpu.ops import composite


def _host_composite(items, stack):
    """Plain numpy composite: flips for negative ids, black for 0."""
    t, ts = stack.shape[0], stack.shape[1]
    nby, nbx = items.shape
    out = np.zeros((nby * ts, nbx * ts, 3), np.uint8)
    for by in range(nby):
        for bx in range(nbx):
            v = int(items[by, bx])
            if v == 0:
                continue
            img = stack[abs(v) - 1]
            out[by * ts:(by + 1) * ts, bx * ts:(bx + 1) * ts] = (
                img if v > 0 else img[:, ::-1]
            )
    return out


@pytest.mark.parametrize("ts,nby,nbx", [(8, 3, 7), (16, 2, 13), (32, 5, 3)])
def test_composite_matches_host(rng, ts, nby, nbx):
    t = 11
    stack = rng.integers(0, 256, (t, ts, ts, 3), dtype=np.uint8)
    items = rng.integers(-t, t + 1, (nby, nbx)).astype(np.int32)
    items[0, 0] = 0
    items[-1, -1] = -t
    got = composite.compose_mosaic(items, stack)
    np.testing.assert_array_equal(got, _host_composite(items, stack))


def test_augmented_stack_is_unpadded(rng):
    stack = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    aug, ts = composite.augment_stack2d(stack)
    assert ts == 32 and aug.shape == (9, 32, 96)  # no lane padding
    a = np.asarray(aug)
    np.testing.assert_array_equal(a[4], stack[0][:, ::-1].reshape(32, 96))
    assert (a[8] == 0).all()  # black row for unassigned blocks


def test_synth_tiles_deterministic_and_trim_safe():
    a = synth.clustered_tiles(50, 8, seed=3)
    b = synth.clustered_tiles(50, 8, seed=3)
    assert a.shape == (50, 8, 8, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    # no pixel white enough for the prep's border trim (> 240)
    assert a.max() <= 210
    assert not np.array_equal(a, synth.clustered_tiles(50, 8, seed=4))


def test_synth_source_and_vectors():
    tiles = synth.clustered_tiles(20, 4, seed=0)
    src, pick = synth.clustered_source(tiles, 3, 5, seed=1)
    assert src.shape == (12, 20, 3) and pick.shape == (3, 5)
    # each block sits within the noise of the tile it was drawn from
    blk = src[4:8, 8:12].astype(int)
    assert np.abs(blk - tiles[pick[1, 2]].astype(int)).max() <= 6
    blocks, lib = synth.clustered_vectors(7, 30, 12, seed=2)
    assert blocks.shape == (7, 12) and lib.shape == (30, 12)
    with pytest.raises(ValueError, match="multiple of 3"):
        synth.clustered_vectors(1, 1, 10, seed=0)
