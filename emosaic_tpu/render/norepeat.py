"""Global-greedy no-repeat renderer (reference: rendering.rs:262-401).

Two phases, mapped device-first:
1. "Scoring": the reference fetches 100 000 NN per block in parallel
   (rendering.rs:307-321) — with its 32 767-tile cap that is simply the
   *full sorted candidate list*. Here the device top-k kernel produces the
   lists in one batch; K is the full library when affordable (exact parity)
   and a truncated prefix with exact masked refills otherwise.
2. Assignment: best-match-first priority queue with mirror-pair exclusion
   (render/greedy.py), exactly the worklist semantics of
   rendering.rs:323-392.

Stats parity: this renderer records *output-pixel* coordinates
(rendering.rs:357-364) — unlike `render_nto1` (quirk preserved,
SURVEY.md section 3.5).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from emosaic_tpu.ops import distance as _distance
from emosaic_tpu.ops.distance import (
    DeviceRefiller,
    l1_dist_matrix,
    l1_topk_adaptive,
    l1_topk_hybrid,
)
from emosaic_tpu.render.greedy import greedy_global_assign, make_numpy_refill
from emosaic_tpu.render.matched import (
    RenderOutcome,
    finish_render,
    start_render,
)
from emosaic_tpu.tiles.tileset import TileSet

#: full-list (exact) mode is used while B * L stays under this many entries
_EXACT_BUDGET = 2 * 10**8
#: auto-enable the batched device refill (ops/distance.DeviceRefiller)
#: once L * D makes the C++ engine's per-block host refill scan expensive
#: (~0.1 GB of AVX2 scan per exhausted block at flagship shape). Output
#: is bit-identical either way; EMOSAIC_DEVICE_REFILL=0/1 overrides.
_DEVICE_REFILL_MIN_LD = 10**8
#: Past _EXACT_BUDGET the scorer fetches this many exact candidates per
#: block (device stripes + top_k). Truncation does NOT change assignment
#: results: the greedy engines fall back to an exact masked refill
#: whenever a block exhausts its prefix (render/greedy.py), so the
#: consumed candidate sequence is identical to the full sorted list —
#: K only trades scoring time against refill frequency. Refills become
#: common only when assigned blocks approach 2T (the feasibility bound
#: of rendering.rs:150-156).
_TRUNCATED_K = 512


def render_nto1_no_repeat(
    source_img: np.ndarray,
    tile_set: TileSet,
    tile_size: int,
    *,
    stack: np.ndarray | None = None,
    compose: bool = True,
    scorer: str = "exact",
    mesh=None,
    log=lambda *a: print(*a, file=sys.stderr),
) -> RenderOutcome:
    if scorer not in ("exact", "hybrid"):
        # fail loud: a typo would otherwise silently run the exact path
        raise ValueError(f"scorer must be 'exact' or 'hybrid', got {scorer!r}")
    dim, htiles, vtiles, blocks, lib = start_render(
        source_img, tile_set, tile_size, log, check_tiles=True
    )
    num_tiles = len(tile_set)
    b, l = blocks.shape[0], lib.shape[0]

    t0 = time.perf_counter()
    if scorer == "hybrid" and b * l > _EXACT_BUDGET:
        # NOTE: precedence matches render/matched.py — an explicit
        # `--matcher hybrid` wins over `--mesh` (the mesh applies to the
        # exact scorers only; --mesh help documents this)
        scorer_used = "hybrid"
    elif mesh is not None:
        scorer_used = "sharded-exact"
    elif b * l <= _EXACT_BUDGET and lib.nbytes <= _distance._lib_budget():
        # exact-full uploads the whole library for the dense matrix;
        # beyond-budget libraries take the adaptive route, whose gate
        # streams host banks (truncation to K does not change assignment
        # results — see _TRUNCATED_K)
        scorer_used = "exact-full"
    else:
        scorer_used = "adaptive-exact"

    if scorer_used == "sharded-exact":
        # multi-chip scoring: the adaptive certified scorer with blocks
        # sharded over every mesh device (library replicated); shapes it
        # declines — and concentrated data caught by its sample gate —
        # route inside to the stripes scorer (blocks over "data", library
        # over "model", per-shard top-k merged by all-gather). Both paths are
        # bit-identical to the single-chip scorers
        # (tests/test_sharding.py). Truncation to K does not change
        # assignment results (see _TRUNCATED_K note): the greedy engines
        # refill exactly when a block's prefix runs dry.
        from emosaic_tpu.parallel import sharded_l1_topk_adaptive

        k = min(_TRUNCATED_K, l)
        cd, cr = sharded_l1_topk_adaptive(blocks, lib, k, mesh)
    elif scorer_used == "hybrid":
        # matmul L2-prefilter + exact-L1 rescore (approximate candidate set,
        # exact distances; ~3.5x faster scoring at flagship scale — see
        # ops/distance.py hybrid section). Assignment still refills
        # exactly, so only candidate-set membership is approximate.
        k = min(_TRUNCATED_K, l)
        cd, cr = l1_topk_hybrid(blocks, lib, k, k_pre=min(2 * k, l))
    elif scorer_used == "exact-full":
        # exact mode: the full sorted candidate list per block (what the
        # reference's 100k-NN fetch amounts to under its tile cap) — dense
        # matrix on device, stable argsort on host (a running device top-k
        # at k = L is orders of magnitude slower)
        dist = l1_dist_matrix(blocks, lib)
        cr = np.argsort(dist, axis=1, kind="stable").astype(np.int32)
        cd = np.take_along_axis(dist, cr, axis=1).astype(np.int32)
    else:
        # exact truncated lists via the adaptive coarse-to-fine certified
        # scorer (ops/distance.py): clusterable libraries prune ~6x of
        # the scoring work; concentrated data routes to the direct
        # two-level scorer — results are identical either way
        k = min(_TRUNCATED_K, l)
        cd, cr = l1_topk_adaptive(blocks, lib, k)
        cd, cr = np.asarray(cd), np.asarray(cr)
    log(f"   scoring ({scorer_used}): {time.perf_counter() - t0:.2f}s")
    from emosaic_tpu import native

    t0 = time.perf_counter()
    if native.available():
        mode = os.environ.get("EMOSAIC_DEVICE_REFILL", "auto")
        # read the budget at call time (via the module) so tuning or
        # test monkeypatching of distance._DEVICE_LIB_BYTES_MAX applies
        oversized = lib.nbytes > _distance._lib_budget()  # refiller uploads whole lib
        want_dev = (
            mode == "1"
            or (mode not in ("0", "off") and l * lib.shape[1] >= _DEVICE_REFILL_MIN_LD)
        ) and not oversized
        if mode == "1" and oversized:
            log(
                "   EMOSAIC_DEVICE_REFILL=1 overridden: library exceeds the"
                " device-resident budget; refills use the exact host scan"
            )
        refiller = DeviceRefiller(blocks, lib) if want_dev else None
        rows, dists = native.greedy_global(
            cd, cr, blocks, lib, num_tiles,
            refill_cb=refiller,
            cb_max_batch=refiller.max_batch if refiller else 4096,
        )
        if refiller is not None and refiller.n_calls:
            log(f"   device refill events: {refiller.n_calls}")
    else:
        refill = make_numpy_refill(blocks, lib)
        rows, dists = greedy_global_assign(cd, cr, l, num_tiles, refill)
    log(f"   assignment: {time.perf_counter() - t0:.2f}s")

    # stats_step=tile_size: output-pixel coords (rendering.rs:357-364)
    return finish_render(
        rows, dists, vtiles, htiles, tile_set, tile_size, tile_size,
        stack=stack, compose=compose, timed_log=log,
    )
