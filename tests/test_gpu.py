"""Checks that need an NVIDIA GPU: the routes compiled for the card against
the plain references. They skip elsewhere; on a GPU host run
`EMOSAIC_TEST_GPU=1 python -m pytest tests -m gpu` (chip_smoke.py runs
the same comparisons at the flagship widths)."""

import numpy as np
import pytest

from emosaic_tpu import synth
from emosaic_tpu.ops import composite, distance

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("d", [12, 48, 192, 256])
def test_triton_kernel_compiled_matches_oracle(gpu, d):
    rng = np.random.default_rng(d)  # uniform data: any d, many near-ties
    blocks = rng.integers(0, 256, (1000, d), dtype=np.uint8)
    lib = rng.integers(0, 256, (5003, d), dtype=np.uint8)
    got = distance.l1_argmin_triton(blocks, lib)
    ref = distance.l1_argmin_xla(blocks, lib)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("d", [12, 768, 3072])
def test_auto_route_matches_oracle(gpu, d):
    blocks, lib = synth.clustered_vectors(512, 4001, d, seed=d)
    got = distance.l1_argmin(blocks, lib)
    ref = distance.l1_argmin_xla(blocks, lib)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_tint_blend_exhaustive_on_card(gpu):
    m = np.broadcast_to(
        np.arange(256, dtype=np.uint8)[:, None, None], (256, 256, 3)
    )
    s = np.broadcast_to(
        np.arange(256, dtype=np.uint8)[None, :, None], (256, 256, 3)
    )
    for alpha in range(1, 256):
        got = composite.tint_blend(m, s, (alpha + 0.5) / 255.0)
        assert (got == composite.ref_tint_blend_u8(m, s, alpha)).all(), alpha
