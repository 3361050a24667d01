// emosaic_tpu native runtime helpers.
//
// The GPU owns every batched kernel (analysis, distance, top-k, composite);
// what remains host-side is the inherently *sequential* state machine of
// no-repeat assignment (a mutating used-set — the reference serializes this
// through a RwLock'd kd-tree, rendering.rs:163-167 / :346-392) and small
// per-image scans. These are implemented here in C++ and loaded via ctypes
// (emosaic_tpu/native.py), with pure-Python fallbacks kept for parity
// testing.
//
// Contracts mirror emosaic_tpu/render/greedy.py exactly (same tie-breaks:
// heap ties by block index, candidate ties by (distance, row)); refills are
// exact masked linear scans over the u8 library instead of a Python
// callback.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int32_t kI32Max = INT32_MAX;

// Exact u8 L1 distance. With AVX2 this rides PSADBW (sum of absolute
// byte differences, 32 bytes/instruction) — the refill scan over a
// 65k x 3072 library drops from ~200 ms to ~5 ms per refilling block,
// which is what makes exact masked refills affordable on heavily
// clustered libraries (many blocks exhaust their top-K prefix).
inline int32_t l1_dist_u8(const uint8_t* a, const uint8_t* b, int64_t d) {
#if defined(__AVX2__)
  __m256i acc = _mm256_setzero_si256();
  int64_t i = 0;
  for (; i + 32 <= d; i += 32) {
    __m256i va = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(a + i));
    __m256i vb = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(b + i));
    acc = _mm256_add_epi64(acc, _mm256_sad_epu8(va, vb));
  }
  __m128i lo = _mm256_castsi256_si128(acc);
  __m128i hi = _mm256_extracti128_si256(acc, 1);
  __m128i s = _mm_add_epi64(lo, hi);
  int64_t total = _mm_cvtsi128_si64(s) + _mm_extract_epi64(s, 1);
  for (; i < d; ++i) total += std::abs(int(a[i]) - int(b[i]));
  return static_cast<int32_t>(total);
#else
  int32_t dist = 0;
  for (int64_t i = 0; i < d; ++i) dist += std::abs(int(a[i]) - int(b[i]));
  return dist;
#endif
}

// Sum of a u8 vector (SIMD via SAD against zero where available).
inline int64_t sum_u8(const uint8_t* a, int64_t d) {
#if defined(__AVX2__)
  __m256i zero = _mm256_setzero_si256();
  __m256i acc = zero;
  int64_t i = 0;
  for (; i + 32 <= d; i += 32) {
    __m256i va = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(a + i));
    acc = _mm256_add_epi64(acc, _mm256_sad_epu8(va, zero));
  }
  __m128i lo = _mm256_castsi256_si128(acc);
  __m128i hi = _mm256_extracti128_si256(acc, 1);
  __m128i s = _mm_add_epi64(lo, hi);
  int64_t total = _mm_cvtsi128_si64(s) + _mm_extract_epi64(s, 1);
  for (; i < d; ++i) total += a[i];
  return total;
#else
  int64_t total = 0;
  for (int64_t i = 0; i < d; ++i) total += a[i];
  return total;
#endif
}

// Exact masked top-k (ascending by (dist, row)) over the library for one
// block — the refill path (reference: re-fetch 10 NN from the live tree,
// rendering.rs:383-385). `row_sums[r]` = sum of lib row r: the coarse
// bound |sum(a) - sum(b)| <= L1(a, b) skips the full-D distance for rows
// that provably can't enter the running top-k (exact: a row is skipped
// only when its bound strictly exceeds the current k-th (dist, row) key,
// so boundary ties are always computed).
void masked_topk(const uint8_t* block, const uint8_t* lib, int64_t L,
                 int64_t D, const std::vector<uint8_t>& used,
                 const std::vector<int64_t>& row_sums, int k,
                 std::vector<std::pair<int32_t, int32_t>>& out) {
  const int64_t qsum = sum_u8(block, D);
  // max-heap on (dist, row): top() is the current k-th (worst kept) key
  std::priority_queue<std::pair<int32_t, int32_t>> heap;
  for (int64_t r = 0; r < L; ++r) {
    if (used[r]) continue;
    if ((int64_t)heap.size() >= (int64_t)k) {
      int64_t bound = std::llabs(qsum - row_sums[r]);
      if (bound > (int64_t)heap.top().first) continue;
    }
    const uint8_t* row = lib + r * D;
    int32_t dist = l1_dist_u8(block, row, D);
    if ((int64_t)heap.size() < (int64_t)k) {
      heap.emplace(dist, (int32_t)r);
    } else if (std::make_pair(dist, (int32_t)r) < heap.top()) {
      heap.pop();
      heap.emplace(dist, (int32_t)r);
    }
  }
  out.clear();
  out.resize(heap.size());
  for (int64_t i = (int64_t)heap.size() - 1; i >= 0; --i) {
    out[i] = heap.top();
    heap.pop();
  }
}

// Per-block candidate stream: dense [K] prefix + refill extras.
struct Stream {
  int64_t cursor = 0;       // position in the dense prefix
  size_t ecursor = 0;       // position in extras
  std::vector<std::pair<int32_t, int32_t>> extras;
  bool assigned = false;    // block already holds a tile (skip in batches)
  bool dead = false;        // a refill returned nothing: library exhausted
};

// Batched-refill callback (device top-k over the masked library). Fills
// out_d/out_r as [m, k] ascending (dist, row), I32_MAX-padded. Returns 0
// on success; nonzero falls back to the host masked scan. `used` is the
// live mask (uint8[L], nonzero = excluded).
typedef int32_t (*emosaic_refill_cb)(void* user, const int64_t* block_ids,
                                     int64_t m, const uint8_t* used,
                                     int32_t* out_d, int32_t* out_r);

struct Ctx {
  const int32_t* cand_d;
  const int32_t* cand_r;
  int64_t K;
  const uint8_t* blocks;
  const uint8_t* lib;
  int64_t L, D;
  std::vector<uint8_t> used;
  std::vector<Stream> streams;
  // live count of unused library rows: when it hits zero, every refill
  // is known-empty without scanning. At full library consumption ~96k
  // post-exhaustion refills would otherwise each pay a pruned row_sums
  // scan (most of that run's assignment time).
  int64_t n_unused = 0;
  // optional batched device refill (see emosaic_refill_cb)
  emosaic_refill_cb cb = nullptr;
  void* cb_user = nullptr;
  int64_t cb_k = 0;          // candidates per block per callback refill
  int64_t cb_margin = 8;     // pre-refill blocks with <= this many raw
                             // candidates left (output-identical: extras
                             // pass the same used-check at pop time)
  int64_t cb_max_batch = 4096;
  // EMOSAIC_NATIVE_STATS=1 diagnostics
  int64_t n_refills = 0;
  int64_t n_peeks = 0;
  int64_t n_cb_calls = 0;
  int64_t n_cb_blocks = 0;
  double refill_secs = 0.0;
  double cb_secs = 0.0;
  // lazy per-row library sums for the refill's coarse bound
  std::vector<int64_t> row_sums;

  // Batched callback refill: one device call covers `b` plus every other
  // live block whose candidate stream is nearly dry. Early refills are
  // output-identical to at-exhaustion refills — the used-mask only grows,
  // so an early batch sees a superset of unused rows; entries that get
  // claimed in the meantime fail the used-check at pop time exactly like
  // prefix entries do, and stale heap keys only cause no-op pops (the
  // same invariant that makes the host refill batch size a pure perf
  // knob). Returns true when the callback delivered (even if some blocks
  // got zero rows — those are marked dead: the mask only grows, so an
  // empty masked top-k can never become non-empty later).
  bool refill_batch(int64_t b) {
    std::vector<int64_t> ids;
    ids.push_back(b);
    const int64_t B = (int64_t)streams.size();
    for (int64_t j = 0; j < B && (int64_t)ids.size() < cb_max_batch; ++j) {
      if (j == b) continue;
      Stream& t = streams[j];
      if (t.assigned || t.dead) continue;
      int64_t rem = (t.cursor < K ? K - t.cursor : 0) +
                    (int64_t)(t.extras.size() - t.ecursor);
      if (rem <= cb_margin) ids.push_back(j);
    }
    const int64_t m = (int64_t)ids.size();
    std::vector<int32_t> od((size_t)(m * cb_k));
    std::vector<int32_t> orr((size_t)(m * cb_k));
    auto t0 = std::chrono::steady_clock::now();
    int32_t rc = cb(cb_user, ids.data(), m, used.data(), od.data(), orr.data());
    cb_secs += std::chrono::duration<double>(
                   std::chrono::steady_clock::now() - t0)
                   .count();
    if (rc != 0) return false;
    ++n_cb_calls;
    n_cb_blocks += m;
    for (int64_t i = 0; i < m; ++i) {
      Stream& t = streams[ids[i]];
      size_t added = 0;
      for (int64_t j = 0; j < cb_k; ++j) {
        int32_t d = od[(size_t)(i * cb_k + j)];
        if (d == kI32Max) break;  // ascending + padded: rest is padding
        t.extras.emplace_back(d, orr[(size_t)(i * cb_k + j)]);
        ++added;
      }
      if (added == 0) t.dead = true;
    }
    return true;
  }

  // Current best candidate for block b, or {false,...} when the library is
  // exhausted. Refills at most once per call.
  // First candidate of b whose row is still UNUSED (candidates claimed
  // since they were fetched are skipped in one linear run here — under
  // tail contention that replaces one heap pop/push cycle per stolen
  // candidate, which dominated assignment at max scale). The used-set
  // only grows and every stream ascends, so the first-unused distance is
  // monotone per block: callers that cached an older distance requeue at
  // the returned one (run_greedy_global).
  bool peek(int64_t b, int32_t* dist, int32_t* row) {
    ++n_peeks;
    Stream& s = streams[b];
    for (;;) {
      if (s.cursor < K) {
        int32_t d = cand_d[b * K + s.cursor];
        if (d == kI32Max) {
          s.cursor = K;  // padded-out prefix: exhausted
          continue;
        }
        int32_t r = cand_r[b * K + s.cursor];
        if (!used[r]) {
          *dist = d;
          *row = r;
          return true;
        }
        ++s.cursor;  // claimed since scoring: skip the whole run
        continue;
      }
      if (s.ecursor < s.extras.size()) {
        if (!used[s.extras[s.ecursor].second]) {
          *dist = s.extras[s.ecursor].first;
          *row = s.extras[s.ecursor].second;
          return true;
        }
        ++s.ecursor;
        continue;
      }
      if (s.dead) return false;  // an earlier refill came back empty
      if (n_unused == 0) {       // library exhausted: refills cannot help
        s.dead = true;
        return false;
      }
      // refill from the live (masked) library. The reference re-fetches
      // 10 NN (rendering.rs:383-385); here the batch is 256 — extras are
      // consumed through the same used-row check, so any batch size
      // yields the identical assignment sequence (verified bit-equal at
      // 10/256/1024 on the 32k-tile clustered flagship), and under
      // cluster contention a 10-row batch forces thousands of rescans
      // (assignment 18 s -> ~5 s measured; a tighter batch also tightens
      // the coarse bound's pruning threshold). With a callback installed
      // the refill is one batched device top-k over every nearly-dry
      // block instead. Fresh entries excluded used rows at scan time, so
      // the next loop iteration returns (or sees the stream dead).
      if (cb != nullptr && refill_batch(b)) continue;
      std::vector<std::pair<int32_t, int32_t>> fresh;
      auto t0 = std::chrono::steady_clock::now();
      if (row_sums.empty()) {
        row_sums.resize(L);
        for (int64_t r = 0; r < L; ++r) row_sums[r] = sum_u8(lib + r * D, D);
      }
      masked_topk(blocks + b * D, lib, L, D, used, row_sums, 256, fresh);
      ++n_refills;
      refill_secs += std::chrono::duration<double>(
                         std::chrono::steady_clock::now() - t0)
                         .count();
      for (auto& f : fresh) s.extras.push_back(f);
      if (fresh.empty()) s.dead = true;
    }
    return false;
  }

  void advance(int64_t b) {
    Stream& s = streams[b];
    if (s.cursor < K) {
      s.cursor++;
    } else {
      s.ecursor++;
    }
  }
};

// Shared body of the global-greedy exports: best-match-first priority
// queue with mirror-pair exclusion (rendering.rs:346-392), tie-broken by
// block index like the Python engine.
int run_greedy_global(Ctx& ctx, int64_t B, int64_t num_tiles,
                      int32_t* out_row, int32_t* out_dist) {
  ctx.used.assign(ctx.L, 0);
  ctx.n_unused = ctx.L;
  ctx.streams.assign(B, Stream{});
  for (int64_t i = 0; i < B; ++i) {
    out_row[i] = -1;
    out_dist[i] = 0;
  }
  using Entry = std::pair<int32_t, int64_t>;  // (current best dist, block)
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap;
  for (int64_t b = 0; b < B; ++b) {
    if (ctx.cand_d[b * ctx.K] != kI32Max)
      heap.emplace(ctx.cand_d[b * ctx.K], b);
  }
  while (!heap.empty()) {
    auto [key, b] = heap.top();
    heap.pop();
    int32_t d, r;
    if (!ctx.peek(b, &d, &r)) continue;  // library empty: skip block
    if (d != key) {
      // stale entry: candidates were claimed since this key was pushed.
      // peek skipped the whole used run; requeue at the true first-unused
      // distance (monotone >= key), where global best-first order decides
      // again. Output-identical to cycling the heap per candidate — the
      // (dist, block) pop order is insertion-independent.
      heap.emplace(d, b);
      continue;
    }
    ctx.advance(b);
    ctx.used[r] = 1;
    int64_t mirror = r < num_tiles ? r + num_tiles : r - num_tiles;
    ctx.n_unused -= 1 + (ctx.used[mirror] == 0);
    ctx.used[mirror] = 1;
    out_row[b] = r;
    out_dist[b] = d;
    ctx.streams[b].assigned = true;
    if (ctx.n_unused == 0) break;  // nothing left to assign: skip the drain
  }
  if (std::getenv("EMOSAIC_NATIVE_STATS")) {
    std::fprintf(stderr,
                 "[native] greedy_global: peeks=%lld refills=%lld "
                 "refill_time=%.2fs cb_calls=%lld cb_blocks=%lld "
                 "cb_time=%.2fs\n",
                 (long long)ctx.n_peeks, (long long)ctx.n_refills,
                 ctx.refill_secs, (long long)ctx.n_cb_calls,
                 (long long)ctx.n_cb_blocks, ctx.cb_secs);
  }
  return 0;
}

}  // namespace

extern "C" {

// In-render no-repeat (reference --no-repeat --greedy): fixed `order`,
// row-granular exclusion (only the chosen orientation is removed).
// Returns 0 on success.
int emosaic_greedy_sequence(const int32_t* order, const int32_t* cand_d,
                            const int32_t* cand_r, int64_t B, int64_t K,
                            const uint8_t* blocks, const uint8_t* lib,
                            int64_t L, int64_t D, int32_t* out_row,
                            int32_t* out_dist) {
  Ctx ctx{cand_d, cand_r, K, blocks, lib, L, D};
  ctx.used.assign(L, 0);
  ctx.n_unused = L;  // row-granular exclusion (no mirror pair here)
  ctx.streams.assign(B, Stream{});
  for (int64_t i = 0; i < B; ++i) {
    out_row[i] = -1;
    out_dist[i] = 0;
  }
  for (int64_t i = 0; i < B; ++i) {
    int64_t b = order[i];
    int32_t d, r;
    while (ctx.peek(b, &d, &r)) {
      ctx.advance(b);
      if (!ctx.used[r]) {
        ctx.used[r] = 1;
        --ctx.n_unused;
        out_row[b] = r;
        out_dist[b] = d;
        break;
      }
    }
  }
  return 0;
}

// Global greedy no-repeat (reference --no-repeat): best-match-first
// priority queue, mirror-pair exclusion. Ties by block index (matches the
// Python engine). Returns 0 on success.
int emosaic_greedy_global(const int32_t* cand_d, const int32_t* cand_r,
                          int64_t B, int64_t K, const uint8_t* blocks,
                          const uint8_t* lib, int64_t L, int64_t D,
                          int64_t num_tiles, int32_t* out_row,
                          int32_t* out_dist) {
  Ctx ctx{cand_d, cand_r, K, blocks, lib, L, D};
  return run_greedy_global(ctx, B, num_tiles, out_row, out_dist);
}

// Global greedy with a batched device-refill callback: identical output
// to emosaic_greedy_global (see Ctx::refill_batch for the argument); the
// host masked scan remains the per-event fallback when the callback
// reports failure. `cb_k` is the per-block candidate count the callback
// writes; `cb_margin`/`cb_max_batch` tune which nearly-dry blocks ride
// along in each batch (pure perf knobs).
int emosaic_greedy_global_cb(const int32_t* cand_d, const int32_t* cand_r,
                             int64_t B, int64_t K, const uint8_t* blocks,
                             const uint8_t* lib, int64_t L, int64_t D,
                             int64_t num_tiles, emosaic_refill_cb cb,
                             void* user, int64_t cb_k, int64_t cb_margin,
                             int64_t cb_max_batch, int32_t* out_row,
                             int32_t* out_dist) {
  Ctx ctx{cand_d, cand_r, K, blocks, lib, L, D};
  ctx.cb = cb;
  ctx.cb_user = user;
  ctx.cb_k = cb_k;
  ctx.cb_margin = cb_margin;
  ctx.cb_max_batch = cb_max_batch;
  if (cb_k <= 0 || cb_max_batch <= 0) return 1;
  return run_greedy_global(ctx, B, num_tiles, out_row, out_dist);
}

// White-border trim rectangle (reference utils.rs:108-175 semantics; see
// emosaic_tpu/io/prep.py trim_bounds for the most-common-boundary rule).
// out = {left, top, width, height}; out[0] = -1 when the image trims to
// nothing.
void emosaic_trim_bounds(const uint8_t* img, int64_t h, int64_t w,
                         int32_t* out) {
  auto is_white = [&](int64_t y, int64_t x) {
    const uint8_t* p = img + (y * w + x) * 3;
    return p[0] > 240 && p[1] > 240 && p[2] > 240;
  };
  std::vector<int64_t> from_left(h), from_right(h), from_top(w), from_bottom(w);
  for (int64_t y = 0; y < h; ++y) {
    int64_t first = w, last = -1;
    for (int64_t x = 0; x < w; ++x) {
      if (!is_white(y, x)) {
        if (first == w) first = x;
        last = x;
      }
    }
    from_left[y] = first;
    from_right[y] = last < 0 ? 0 : last;
  }
  for (int64_t x = 0; x < w; ++x) {
    int64_t first = h, last = -1;
    for (int64_t y = 0; y < h; ++y) {
      if (!is_white(y, x)) {
        if (first == h) first = y;
        last = y;
      }
    }
    from_top[x] = first;
    from_bottom[x] = last < 0 ? 0 : last;
  }
  // most common value; ties -> smallest; empty -> 0
  auto most_common = [](std::vector<int64_t> v, int64_t exclude) -> int64_t {
    v.erase(std::remove(v.begin(), v.end(), exclude), v.end());
    if (v.empty()) return 0;
    std::sort(v.begin(), v.end());
    int64_t best = v[0], best_count = 0;
    int64_t cur = v[0], count = 0;
    for (int64_t x : v) {
      if (x == cur) {
        count++;
      } else {
        if (count > best_count) {
          best = cur;
          best_count = count;
        }
        cur = x;
        count = 1;
      }
    }
    if (count > best_count) best = cur;
    return best;
  };
  int64_t first_col = most_common(from_left, w);
  int64_t last_col = most_common(from_right, 0);
  int64_t first_row = most_common(from_top, h);
  int64_t last_row = most_common(from_bottom, 0);
  if (!(first_col < last_col && first_row < last_row)) {
    out[0] = -1;
    return;
  }
  out[0] = (int32_t)first_col;
  out[1] = (int32_t)first_row;
  out[2] = (int32_t)(last_col - first_col);
  out[3] = (int32_t)(last_row - first_row);
}

}  // extern "C"
