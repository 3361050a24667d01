#!/usr/bin/env python
"""Multi-controller validation: the production sharded kernels across
REAL process boundaries.

The in-repo sharding CI (tests/test_sharding.py, dryrun_multichip) runs
on a single-process 8-device virtual CPU mesh — XLA collectives there
never leave one process's runtime. On a multi-host cluster they do: each
host runs its own controller over its local devices and every
all_gather/psum in `parallel/sharded.py` crosses the network. This tool
reproduces that
topology with what this machine has: TWO OS processes x FOUR virtual
CPU devices each, joined by `jax.distributed.initialize` (gloo
transport), forming one global 8-device ("data", "model") mesh.

Checks (each bit-compared against the single-device oracle computed
independently inside every process):
  - sharded_l1_argmin          (all-gather (min, argmin) combine)
  - sharded_l1_argmin_ring     (ring-rotation combine)
  - sharded_l1_topk            (segmented top-k + cross-shard merge)
  - sharded_l1_topk_adaptive   (certified adaptive scorer, block-sharded)
  - sharded_mosaic_step        (analysis -> match -> composite, one jit)
  - beyond-budget bank streaming THROUGH the sharded adaptive scorer
    (a tiny forced device budget — host banks stream across the
    multi-process mesh, prefetch worker thread included)
plus `parallel.distributed.fetch` (the multihost all-gather fetch) on
every sharded output, and cross-process agreement on the fetched bytes.

Usage:
  python tools/cpu_multiproc_dryrun.py            # parent: spawns ranks
  python tools/cpu_multiproc_dryrun.py --rank N --port P   # child

Exit 0 = every check passed in both ranks. Runs entirely on CPU and
never takes an accelerator. ~60 s (fresh XLA CPU compiles in both
children).

Reference analogue: none — the reference is single-host rayon
(rendering.rs:68-70); this is the multi-host axis of the design
validated as far as a one-host environment allows.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 2
LOCAL_DEVICES = 4


def child(rank: int, port: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from emosaic_tpu.parallel.distributed import init_distributed

    os.environ["EMOSAIC_COORDINATOR"] = f"localhost:{port}"
    os.environ["EMOSAIC_NUM_PROCESSES"] = str(N_PROCS)
    os.environ["EMOSAIC_PROCESS_ID"] = str(rank)
    init_distributed()

    import numpy as np

    from emosaic_tpu.ops import distance
    from emosaic_tpu.ops.analysis import analyse_batch, source_blocks
    from emosaic_tpu.ops.composite import compose_mosaic
    from emosaic_tpu.ops.distance import (
        build_library,
        l1_argmin_xla,
        rows_to_items,
    )
    from emosaic_tpu.parallel import (
        make_mesh,
        sharded_l1_argmin,
        sharded_l1_argmin_ring,
        sharded_l1_topk,
        sharded_l1_topk_adaptive,
        sharded_mosaic_step,
    )
    from emosaic_tpu.parallel.distributed import fetch, is_multiprocess

    assert is_multiprocess(), "distributed init did not take"
    assert jax.process_count() == N_PROCS
    n = N_PROCS * LOCAL_DEVICES
    assert len(jax.devices()) == n, (len(jax.devices()), n)
    assert len(jax.local_devices()) == LOCAL_DEVICES

    say = lambda m: print(f"[rank {rank}] {m}", flush=True)  # noqa: E731
    mesh = make_mesh(n, model=2)
    say(f"global mesh up: {dict(mesh.shape)}")

    # identical seeds in every process: multi-controller SPMD requires
    # every rank to pass the same host values
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, 256, size=(131, 12), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(194, 12), dtype=np.uint8)
    # duplicated rows force cross-shard (and cross-PROCESS) ties: the
    # (distance, lowest-row) tie-break must survive the gloo combine
    lib[50] = lib[3]
    blocks[7] = lib[3]

    d_o, r_o = map(np.asarray, l1_argmin_xla(blocks, lib))

    d, r = sharded_l1_argmin(blocks, lib, mesh)
    np.testing.assert_array_equal(fetch(d), d_o)
    np.testing.assert_array_equal(fetch(r), r_o)
    say("argmin (all-gather combine) bit-identical")

    d, r = sharded_l1_argmin_ring(blocks, lib, mesh)
    np.testing.assert_array_equal(fetch(d), d_o)
    np.testing.assert_array_equal(fetch(r), r_o)
    say("argmin (ring combine) bit-identical")

    k = 7
    dt_o, rt_o = map(np.asarray, distance.l1_topk_stripes(blocks, lib, k))
    dt, rt = sharded_l1_topk(blocks, lib, k, mesh)
    np.testing.assert_array_equal(fetch(dt), dt_o)
    np.testing.assert_array_equal(fetch(rt), rt_o)
    say("top-k bit-identical")

    da, ra = sharded_l1_topk_adaptive(blocks, lib, k, mesh)
    np.testing.assert_array_equal(fetch(da), dt_o)
    np.testing.assert_array_equal(fetch(ra), rt_o)
    say("adaptive top-k bit-identical")

    dim, ts, t = 2, 4, 32
    tiles = rng.integers(0, 256, size=(t, ts, ts, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(16, 12, 3), dtype=np.uint8)
    out = sharded_mosaic_step(tiles, src, mesh, dim, ts)
    pal = np.asarray(analyse_batch(tiles, dim))
    lib2 = np.asarray(build_library(pal))
    blocks2 = np.asarray(source_blocks(src, dim))
    _, rows = l1_argmin_xla(blocks2, lib2)
    items = np.asarray(rows_to_items(rows, t)).reshape(8, 6)
    ref = np.asarray(compose_mosaic(items, tiles))
    np.testing.assert_array_equal(out, ref)
    say("mosaic step (analysis->match->composite) bit-identical")

    # beyond-budget bank streaming ACROSS process boundaries: a tiny
    # forced device-library budget makes the sharded adaptive scorer
    # stream host banks through itself on the global mesh (the same
    # composition the production no-repeat path takes past HBM)
    big_l, big_d = 3000, 48
    big_lib = rng.integers(0, 256, size=(big_l, big_d), dtype=np.uint8)
    big_blocks = rng.integers(0, 256, size=(9, big_d), dtype=np.uint8)
    saved = distance._DEVICE_LIB_BYTES_MAX
    try:
        distance._DEVICE_LIB_BYTES_MAX = 1024 * big_d
        ds, rs = sharded_l1_topk_adaptive(big_blocks, big_lib, 3, mesh)
    finally:
        distance._DEVICE_LIB_BYTES_MAX = saved
    do_, ro_ = map(
        np.asarray, distance.l1_topk_stripes(big_blocks, big_lib, 3)
    )
    np.testing.assert_array_equal(fetch(ds), do_)
    np.testing.assert_array_equal(fetch(rs), ro_)
    say("beyond-budget streamed x sharded (multi-process) bit-identical")

    # cross-process agreement: every rank must hold the same fetched
    # bytes (one more collective: psum of the output checksum)
    import jax.numpy as jnp

    csum = int(
        jax.device_get(
            jax.jit(lambda x: jnp.sum(x.astype(jnp.int64)))(
                jnp.asarray(out.astype(np.int64))
            )
        )
    )
    say(f"output checksum {csum}")
    print(f"[rank {rank}] MULTIPROC_OK", flush=True)


def parent() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={LOCAL_DEVICES}"
    )
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                os.path.abspath(__file__),
                "--rank",
                str(i),
                "--port",
                str(port),
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(N_PROCS)
    ]
    outs = []
    ok = True
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            ok = False
        outs.append(out)
        if p.returncode != 0 or f"[rank {i}] MULTIPROC_OK" not in out:
            ok = False
    checks = [
        ln
        for out in outs
        for ln in out.splitlines()
        if ln.startswith("[rank") and "Gloo" not in ln
    ]
    print("\n".join(checks))
    # both ranks must agree on the output checksum
    sums = {ln.split()[-1] for ln in checks if "checksum" in ln}
    if len(sums) != 1:
        print(f"FAIL: ranks disagree on output checksum: {sums}")
        ok = False
    if not ok:
        for i, out in enumerate(outs):
            tail = "\n".join(
                ln for ln in out.splitlines()[-40:] if "Gloo" not in ln
            )
            print(f"--- rank {i} tail ---\n{tail}")
        print("MULTIPROC_DRYRUN FAIL")
        return 1
    print(
        f"MULTIPROC_DRYRUN OK: {N_PROCS} processes x {LOCAL_DEVICES} "
        "devices, all kernels bit-identical across process boundaries"
    )
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        rank = int(sys.argv[sys.argv.index("--rank") + 1])
        port = int(sys.argv[sys.argv.index("--port") + 1])
        child(rank, port)
    else:
        sys.exit(parent())
