"""Sequential no-repeat assignment engines.

The reference's no-repeat selection is inherently sequential (a mutating
kd-tree): two variants exist —

- in-render removal (`--no-repeat --greedy`, rendering.rs:163-167, :207-209):
  blocks processed in render order; each takes the nearest *available*
  entry and removes only the chosen orientation (a tile and its mirror can
  both appear).
- global greedy (`--no-repeat` alone, rendering.rs:307-392): every block
  gets its full ascending candidate list; a worklist keyed by each block's
  current-best candidate distance is processed best-match-first (the sort
  at rendering.rs:324-326 is descending by `nearest.last()` — the *closest*
  candidate, since the list was reversed — and blocks are popped from the
  vector end, i.e. smallest best-distance first); placing a tile blocks
  both the item and its mirror (rendering.rs:353-354, :365-380); conflicts
  consume a candidate and re-key the block (the binary-search reinsert at
  rendering.rs:387-390 is exactly a priority queue), with a 10-NN refill
  from the live tree when a list is exhausted (rendering.rs:383-385).

Device decomposition: candidate lists come from the device top-k kernel
in one batch; this module runs only the cheap sequential assignment over
those lists, falling back to an exact masked re-query (refill callback) for
the rare exhausted blocks. A C++ engine (native/) accelerates the loop; the
pure-Python implementation here is the reference/fallback.

Determinism: the reference's tie order is unstable-sort/HashMap dependent;
here ties break by block sequence number. Blocks left unassigned when the
library empties keep row -1 and render black (PARITY deviation 16): the
reference only skips-with-black-hole the literal LAST starved block
(rendering.rs:349-351); any earlier starved block's empty refill panics
in compare_matches' `.last().unwrap()` during the ordered reinsert
(rendering.rs:386-390, algorithms.rs:11). This port completes the render
with black tiles for every starved block instead of crashing.
"""

from __future__ import annotations

import heapq
from typing import Callable

import numpy as np

I32_MAX = np.int32(2**31 - 1)

#: refill(block_ids [M], used_rows bool[L]) -> (dists [M,k], rows [M,k])
#: ascending, I32_MAX-padded when fewer than k rows remain.
RefillFn = Callable[[np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]]


def _mirror(row: int, num_tiles: int) -> int:
    return row + num_tiles if row < num_tiles else row - num_tiles


class _CandidateLists:
    """Per-block ascending candidate streams: a dense [B, K] prefix from the
    device top-k pass, extended on demand by exact masked refills."""

    def __init__(self, cand_d: np.ndarray, cand_r: np.ndarray, refill: RefillFn):
        self.cand_d = cand_d
        self.cand_r = cand_r
        self.k = cand_d.shape[1]
        self.cursor = np.zeros(cand_d.shape[0], dtype=np.int64)
        self.extra: dict[int, list[tuple[int, int]]] = {}
        self.ecursor: dict[int, int] = {}
        self.refill = refill
        # set by the driving loop once every library row is used: refills
        # are then known-empty without a masked scan (the C++ engine keeps
        # the same n_unused counter; at full library consumption ~B/2
        # post-exhaustion refills would otherwise each scan the library)
        self.exhausted = False

    def peek(self, blk: int, used: np.ndarray) -> tuple[int, int] | None:
        """Current best candidate (dist, row), refilling if exhausted;
        None when no unused rows remain anywhere."""
        c = self.cursor[blk]
        if c < self.k and self.cand_d[blk, c] != I32_MAX:
            return int(self.cand_d[blk, c]), int(self.cand_r[blk, c])
        self.cursor[blk] = self.k  # dense prefix exhausted (or padded out)
        ex = self.extra.get(blk)
        ec = self.ecursor.get(blk, 0)
        if ex is not None and ec < len(ex):
            return ex[ec]
        # refill from the live (masked) library, like rendering.rs:383-385
        if self.exhausted:
            return None
        d10, r10 = self.refill(np.array([blk]), used)
        valid = d10[0] != I32_MAX
        fresh = [(int(d), int(r)) for d, r in zip(d10[0][valid], r10[0][valid])]
        self.extra[blk] = (ex or []) + fresh if ex else fresh
        self.ecursor.setdefault(blk, 0)
        if self.ecursor[blk] < len(self.extra[blk]):
            return self.extra[blk][self.ecursor[blk]]
        return None

    def advance(self, blk: int) -> None:
        if self.cursor[blk] < self.k:
            self.cursor[blk] += 1
        else:
            self.ecursor[blk] = self.ecursor.get(blk, 0) + 1


def greedy_sequence_assign(
    order: np.ndarray,
    cand_d: np.ndarray,
    cand_r: np.ndarray,
    num_rows: int,
    refill: RefillFn,
) -> tuple[np.ndarray, np.ndarray]:
    """In-render no-repeat: fixed processing order, row-granular exclusion.

    Args:
      order: [B] block indices in processing order.
      cand_d/cand_r: [B, K] ascending candidate (distance, library row).
      num_rows: total library rows (2T).
      refill: exact masked re-query for exhausted candidate lists.

    Returns:
      (chosen_row [B], chosen_dist [B]) int32 indexed by block; row -1 for
      blocks that could not be assigned (library exhausted).
    """
    b = cand_d.shape[0]
    used = np.zeros(num_rows, dtype=bool)
    chosen_row = np.full(b, -1, dtype=np.int32)
    chosen_dist = np.zeros(b, dtype=np.int32)
    lists = _CandidateLists(cand_d, cand_r, refill)
    for blk in order:
        blk = int(blk)
        while True:
            cur = lists.peek(blk, used)
            if cur is None:
                break
            d, r = cur
            lists.advance(blk)
            if not used[r]:
                used[r] = True
                chosen_row[blk] = r
                chosen_dist[blk] = d
                break
    return chosen_row, chosen_dist


def greedy_global_assign(
    cand_d: np.ndarray,
    cand_r: np.ndarray,
    num_rows: int,
    num_tiles: int,
    refill: RefillFn,
) -> tuple[np.ndarray, np.ndarray]:
    """Global greedy no-repeat: best-match-first worklist, mirror-pair
    exclusion (rendering.rs:346-392). See module docstring."""
    b = cand_d.shape[0]
    used = np.zeros(num_rows, dtype=bool)
    n_unused = num_rows
    chosen_row = np.full(b, -1, dtype=np.int32)
    chosen_dist = np.zeros(b, dtype=np.int32)
    lists = _CandidateLists(cand_d, cand_r, refill)

    heap = [(int(cand_d[i, 0]), i) for i in range(b) if cand_d[i, 0] != I32_MAX]
    heapq.heapify(heap)
    while heap:
        _, blk = heapq.heappop(heap)
        cur = lists.peek(blk, used)
        if cur is None:
            continue  # no tiles left anywhere: skip block (rendering.rs:349-351)
        d, r = cur
        lists.advance(blk)
        if not used[r]:
            mirror = _mirror(r, num_tiles)
            n_unused -= 1 + (not used[mirror])
            used[r] = True
            used[mirror] = True  # rendering.rs:353-354
            lists.exhausted = n_unused == 0
            chosen_row[blk] = r
            chosen_dist[blk] = d
        else:
            nxt = lists.peek(blk, used)
            if nxt is not None:
                heapq.heappush(heap, (nxt[0], blk))
    return chosen_row, chosen_dist


def make_numpy_refill(blocks: np.ndarray, lib: np.ndarray, k: int = 256) -> RefillFn:
    """Exact masked re-query on host.

    blocks: [B, D] uint8 queries; lib: [L, D] uint8 library.

    The batch size k is a pure perf knob (the reference re-fetches 10,
    rendering.rs:383-385): extras pass through the same used-row check at
    pop time, so the consumed candidate sequence — and therefore the
    assignment — is identical for any k. Larger batches amortize the
    masked scan under cluster contention (see native/emosaic_native.cpp).
    """
    lib_i = lib.astype(np.int32)

    def refill(block_ids: np.ndarray, used: np.ndarray):
        q = blocks[block_ids].astype(np.int32)  # [M, D]
        dist = np.abs(q[:, None, :] - lib_i[None, :, :]).sum(
            axis=2, dtype=np.int32
        )
        dist[:, used] = I32_MAX
        l = dist.shape[1]
        kk = min(k, l)
        # partition on the packed (distance, row) key — a plain-distance
        # argpartition picks arbitrary tie members at the kth boundary
        # (same hazard as l1_topk; the C++ masked_topk and the device
        # refiller both compare (dist, row) pairs exactly)
        key = dist.astype(np.int64) * l + np.arange(l, dtype=np.int64)[None, :]
        part = np.argpartition(key, kk - 1, axis=1)[:, :kk]
        pk = np.take_along_axis(key, part, axis=1)
        order = np.argsort(pk, axis=1)
        rows = np.take_along_axis(part, order, axis=1).astype(np.int32)
        dists = np.take_along_axis(
            np.take_along_axis(dist, part, axis=1), order, axis=1
        ).astype(np.int32)
        return dists, rows

    return refill
