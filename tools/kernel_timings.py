"""Time each matcher and composite route on the GPU at the flagship widths.

    python tools/kernel_timings.py [--sections argmin,highd,topk,composite]
                                   [--sweep]

Prints the card's name and power limit first, then one line per timing:
the median and minimum of `REPS` runs after a warm-up, each ending in
`block_until_ready`. Every timed route is also compared with its exact
reference (bit-equal distances and rows). Exits non-zero without a GPU.

Shapes: B = 16 384 blocks (a 4096^2 source at dim 32) against L = 65 534
library rows (the reference's 32 767-tile cap with flips). Library data is
the clustered colour-and-texture model of `emosaic_tpu.synth`.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from emosaic_tpu import synth  # noqa: E402
from emosaic_tpu.ops import backend, composite, distance  # noqa: E402

REPS = 5
B, L = 16384, 65534


def log(*a):
    print(*a, flush=True)


def timed(fn, reps: int = REPS):
    """(median s, min s, last result) of `reps` runs after one warm-up."""
    out = jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts), out


def report(name: str, med: float, mn: float, extra: str = ""):
    log(f"TIME {name}: median {med * 1e3:.3f} ms, min {mn * 1e3:.3f} ms {extra}")


def same(a, b) -> bool:
    return all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b)
    )


def argmin_section(sweep: bool):
    for d in (12, 48, 192):
        blocks, lib = synth.clustered_vectors(B, L, d, seed=d)
        bd, ld = jnp.asarray(blocks), jnp.asarray(lib)
        b, l = blocks.shape[0], lib.shape[0]
        configs = [
            (distance._TRITON_BM, distance._TRITON_BN, distance._TRITON_WARPS,
             distance._TRITON_STAGES)
        ]
        if sweep:
            configs += [
                (bm, bn, w, st)
                for bm, bn in ((32, 64), (64, 64), (64, 128), (128, 128))
                for w in (4, 8)
                for st in (2,)
            ]
        seen = set()
        ref = None
        best = None
        for bm, bn, w, st in configs:
            if (bm, bn, w, st) in seen:
                continue
            seen.add((bm, bn, w, st))
            splits = distance._triton_splits(b, l, bm, bn)

            def run():
                return distance._l1_argmin_triton_jit(
                    bd, ld, real_l=l, bm=bm, bn=bn, splits=splits,
                    num_warps=w, num_stages=st,
                )

            try:
                med, mn, out = timed(run, 3 if sweep else REPS)
            except Exception as e:  # a config the compiler refuses
                log(f"FAIL triton D={d} bm={bm} bn={bn} w={w} st={st}: "
                    f"{type(e).__name__}: {str(e)[:300]}")
                continue
            report(f"triton D={d} bm={bm} bn={bn} warps={w} stages={st} "
                   f"splits={splits}", med, mn)
            if ref is None:
                ref = out
            elif not same(out, ref):
                log(f"MISMATCH triton config bm={bm} bn={bn} D={d}")
            if best is None or med < best[0]:
                best = (med, bm, bn, w, st)
        log(f"BEST triton D={d}: {best}")
        bc = distance._STRIPE_BC
        lf, bf = ld.reshape(-1), bd.reshape(-1)
        med, mn, out_s = timed(
            lambda: distance._l1_argmin_stripes_jit(bf, lf, d=d, bc=bc, real_l=l)
        )
        report(f"stripes D={d}", med, mn, f"equal={same(out_s, ref)}")
        bc2, lc = distance._chunk_sizes(d)
        bc2 = min(bc2, B)
        lp = -(-l // lc) * lc
        lpad = jnp.pad(ld, ((0, lp - l), (0, 0))).reshape(-1)
        med, mn, out_x = timed(
            lambda: distance._l1_argmin_xla_jit(
                bf, lpad, d=d, bc=bc2, lc=lc, real_l=l
            )
        )
        report(f"scan D={d}", med, mn, f"equal={same(out_x, ref)}")
        # host int64 brute force on a sample of blocks
        idx = np.random.default_rng(d).choice(b, 256, replace=False)
        full = np.abs(
            blocks[idx].astype(np.int64)[:, None] - lib.astype(np.int64)[None]
        ).sum(-1)
        ok = np.array_equal(np.asarray(ref[0])[idx], full.min(1)) and (
            np.array_equal(np.asarray(ref[1])[idx], full.argmin(1))
        )
        log(f"PARITY triton D={d} host brute force (256 blocks): {ok}")


def adaptive_k1(bf, lpad, ref, d, l, bc):
    _, g, chan, _, _, _, m, cap = distance._ad_plan(B, l, d, 1)

    def ad():
        v, c, s = distance._ad_coarse_jit(
            bf, (lpad,), d=d, g=g, chan=chan, bc=bc, cap=cap, real_l=l
        )
        return distance._ad_rescore_jit(
            bf, v, c, s, (lpad,), d=d, bc=64, m=m, k=1, real_l=l
        )

    med, mn, out = timed(ad)
    okm = np.asarray(out[2])
    eq = all(
        np.array_equal(np.asarray(o)[okm][:, 0], np.asarray(r)[okm])
        for o, r in zip(out[:2], ref)
    )
    report(f"adaptive k=1 D={d}", med, mn,
           f"certified={int(okm.sum())} equal_on_certified={eq}")


def highd_section():
    for d in (768, 3072):
        blocks, lib = synth.clustered_vectors(B, L, d, seed=d)
        bd, ld = jnp.asarray(blocks), jnp.asarray(lib)
        l = lib.shape[0]
        bf, lf = bd.reshape(-1), ld.reshape(-1)
        bc = distance._STRIPE_BC
        med, mn, ref = timed(
            lambda: distance._l1_argmin_stripes_jit(bf, lf, d=d, bc=bc, real_l=l)
        )
        report(f"stripes D={d}", med, mn)
        lp = -(-l // 128) * 128
        lpad = jnp.pad(ld, ((0, lp - l), (0, 0))).reshape(-1)
        med, mn, out = timed(
            lambda: distance._l1_topk_twolevel_jit(
                bf, lpad, d=d, bc=bc, k=1, real_l=l, cap=distance._TL_CAP
            )
        )
        report(f"twolevel k=1 D={d}", med, mn,
               f"equal={same((out[0][:, 0], out[1][:, 0]), ref)} "
               f"certified={int(np.asarray(out[2]).sum())}")
        if d > 768:
            # the adaptive scorer's programs at D = 3072 did not finish
            # compiling within ten minutes on an H100 (docs/KERNELS.md)
            log(f"SKIP adaptive k=1 D={d}")
        else:
            adaptive_k1(bf, lpad, ref, d, l, bc)
        bc2, lc = distance._chunk_sizes(d)
        bc2 = min(bc2, B)
        lp2 = -(-l // lc) * lc
        lpad2 = jnp.pad(ld, ((0, lp2 - l), (0, 0))).reshape(-1)
        med, mn, out = timed(
            lambda: distance._l1_argmin_xla_jit(
                bf, lpad2, d=d, bc=bc2, lc=lc, real_l=l
            )
        )
        report(f"scan D={d}", med, mn, f"equal={same(out, ref)}")


def topk_section(d: int = 768, k: int = 512):
    """No-repeat top-k at mode 16 through `l1_topk_adaptive`, end to end
    (upload, scoring, host stitching): the adaptive scorer against the
    two-level scorer (the table's gate lowered below `d`). Also reports
    the first call, compile included, and which fallbacks each took."""
    blocks, lib = synth.clustered_vectors(B, L, d, seed=d)
    counts = {"twolevel": 0, "fallback rows": 0}
    twolevel, fallback = distance.l1_topk_twolevel, distance._stripe_fallback

    def counting_twolevel(*a, **kw):
        counts["twolevel"] += 1
        return twolevel(*a, **kw)

    def counting_fallback(out_d, out_r, bad, *a, **kw):
        counts["fallback rows"] += len(bad)
        return fallback(out_d, out_r, bad, *a, **kw)

    distance.l1_topk_twolevel = counting_twolevel
    distance._stripe_fallback = counting_fallback
    gate = backend.ADAPTIVE_MAX_D["gpu"]
    outs = {}
    try:
        for name, max_d in (("two-level", d - 1), ("adaptive", d)):
            backend.ADAPTIVE_MAX_D["gpu"] = max_d
            counts.update({"twolevel": 0, "fallback rows": 0})
            t0 = time.perf_counter()
            distance.l1_topk_adaptive(blocks, lib, k)
            first = time.perf_counter() - t0
            med, mn, outs[name] = timed(
                lambda: distance.l1_topk_adaptive(blocks, lib, k)
            )
            report(f"topk {name} k={k} D={d}", med, mn,
                   f"first call {first:.1f} s (compile included); "
                   f"over 7 calls: two-level entered {counts['twolevel']}x, "
                   f"stripe fallback rows {counts['fallback rows']}")
    finally:
        backend.ADAPTIVE_MAX_D["gpu"] = gate
        distance.l1_topk_twolevel = twolevel
        distance._stripe_fallback = fallback
    log(f"PARITY topk adaptive == two-level k={k} D={d}: "
        f"{same(*outs.values())}")


def composite_section():
    rng = np.random.default_rng(5)
    t, ts = 32767, 32
    stack = rng.integers(0, 256, (t, ts, ts, 3), dtype=np.uint8)
    aug3, _ = composite.augment_stack2d(stack)
    for nby, nbx, label in ((128, 128, "flagship 4096^2"),
                            (128, 4096, "1.6 GB band")):
        items = jnp.asarray(
            rng.integers(-t, t + 1, (nby, nbx)).astype(np.int32)
        )
        med, mn, band = timed(
            lambda: composite._compose_rows_xla(items, aug3, ts=ts)
        )
        nbytes = band.size
        report(f"compose {label} ({nbytes / 1e9:.3f} GB)", med, mn,
               f"{2 * nbytes / med / 1e9:.1f} GB/s read+write")
        flat = jnp.zeros((nbytes,), jnp.uint8)
        cp = jax.jit(lambda x: x ^ jnp.uint8(1))
        med, mn, _ = timed(lambda: cp(flat))
        report(f"plain copy {label} ({nbytes / 1e9:.3f} GB)", med, mn,
               f"{2 * nbytes / med / 1e9:.1f} GB/s read+write")
        host = np.asarray(band).reshape(nby * ts, nbx * ts, 3)
        it = np.asarray(items)
        ok = True
        for by, bx in ((0, 0), (nby - 1, nbx - 1), (nby // 2, nbx // 3)):
            v = int(it[by, bx])
            ref = np.zeros((ts, ts, 3), np.uint8) if v == 0 else (
                stack[v - 1] if v > 0 else stack[-v - 1][:, ::-1]
            )
            ok &= np.array_equal(
                host[by * ts:(by + 1) * ts, bx * ts:(bx + 1) * ts], ref
            )
        log(f"PARITY compose {label} sampled tiles: {ok}")
        del band, flat


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--sections", default="argmin,highd,composite")
    p.add_argument("--sweep", action="store_true")
    args = p.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU (platform {dev.platform})", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    log(f"CARD {smi} | jax {jax.__version__} | {dev.device_kind}")
    for sec in args.sections.split(","):
        t0 = time.perf_counter()
        try:
            if sec == "argmin":
                argmin_section(args.sweep)
            else:
                globals()[f"{sec}_section"]()
        except Exception as e:
            import traceback

            traceback.print_exc()
            log(f"SECTION {sec} FAILED: {type(e).__name__}: {e}")
        log(f"SECTION {sec} {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
