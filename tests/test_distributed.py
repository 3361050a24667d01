"""Multi-controller (multi-process) validation.

tests/test_sharding.py proves the sharded kernels on a single-process
8-device virtual mesh; this file proves they survive REAL process
boundaries: tools/cpu_multiproc_dryrun.py joins 2 OS processes x 4
virtual CPU devices into one global mesh via jax.distributed (gloo
transport), so every collective in parallel/sharded.py genuinely
crosses a transport — the closest topology to a multi-host cluster a
one-host environment can express. Reference analogue: none (single-host rayon,
rendering.rs:68-70).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).parent.parent


def test_multiprocess_dryrun_bit_identical():
    """2 processes x 4 devices: every sharded kernel bit-equals its
    single-device oracle in BOTH ranks, and the ranks agree on the
    fetched output bytes. ~60 s (two fresh CPU-XLA child processes)."""
    env = {
        k: v for k, v in os.environ.items() if k != "XLA_FLAGS"
    }  # the tool provisions its own per-child device count
    res = subprocess.run(
        [sys.executable, str(REPO / "tools" / "cpu_multiproc_dryrun.py")],
        capture_output=True,
        text=True,
        timeout=500,
        cwd=REPO,
        env=env,
    )
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-2000:]
    assert "MULTIPROC_DRYRUN OK" in res.stdout
    for rank in (0, 1):
        assert f"[rank {rank}] MULTIPROC_OK" in res.stdout


def _cli_child_code(argv, port=None, rank=None):
    pre = ""
    if port is not None:
        pre = (
            f"os.environ['EMOSAIC_DISTRIBUTED'] = '1'\n"
            f"os.environ['EMOSAIC_COORDINATOR'] = 'localhost:{port}'\n"
            f"os.environ['EMOSAIC_NUM_PROCESSES'] = '2'\n"
            f"os.environ['EMOSAIC_PROCESS_ID'] = '{rank}'\n"
        )
    return (
        "import os\n"
        + pre
        + "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "from emosaic_tpu.cli import main\n"
        f"raise SystemExit(main({argv!r}))\n"
    )


def test_distributed_cli_rank0_writes_bit_identical(tmp_path, rng):
    """EMOSAIC_DISTRIBUTED=1: two CLI ranks join one global mesh, both
    compute, rank 0 alone writes — and its output is bit-identical to a
    plain single-process render of the same scene."""
    import socket

    from PIL import Image

    tiles = tmp_path / "tiles"
    tiles.mkdir()
    for i in range(12):
        base = rng.integers(0, 256, size=3)
        arr = np.clip(base + rng.normal(0, 25, (24, 24, 3)), 0, 255).astype(
            np.uint8
        )
        Image.fromarray(arr).save(tiles / f"t{i}.jpg", quality=92)
    src = rng.integers(0, 256, size=(10, 13, 3), dtype=np.uint8)
    Image.fromarray(src).save(tmp_path / "src.png")

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["XDG_CACHE_HOME"] = str(tmp_path / "xdg")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["EMOSAIC_PREP_WORKERS"] = "1"

    def argv(tag):
        return [
            "-s", "8",
            "-o", str(tmp_path / f"{tag}.png"),
            str(tmp_path / "src.png"),
            "mosaic", str(tiles),
            "-m", "1",
            "--mesh", "auto",
        ]

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _cli_child_code(argv("dist"), port, r)],
            env=env,
            cwd=tmp_path,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for r in (0, 1)
    ]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    assert "rank 0 writes the outputs" in outs[1]  # rank 1 stood down
    assert (tmp_path / "dist.png").exists()

    # single-process oracle (no distributed env, no mesh)
    oracle_env = {
        k: v for k, v in env.items() if not k.startswith("EMOSAIC_PROCESS")
    }
    res = subprocess.run(
        [sys.executable, "-c", _cli_child_code(argv("solo")[:-2])],
        env=oracle_env,
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=420,
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]

    a = np.asarray(Image.open(tmp_path / "dist.png").convert("RGB"))
    b = np.asarray(Image.open(tmp_path / "solo.png").convert("RGB"))
    np.testing.assert_array_equal(a, b)


def test_fetch_single_process_passthrough():
    """fetch() must be a plain device_get for fully-addressable arrays
    (no collective, numpy pass-through for host arrays)."""
    import jax.numpy as jnp

    from emosaic_tpu.parallel.distributed import fetch

    a = np.arange(6).reshape(2, 3)
    assert fetch(a) is a
    x = jnp.arange(6).reshape(2, 3)
    np.testing.assert_array_equal(fetch(x), a)


def test_init_distributed_no_cluster_is_noop():
    """Without a cluster environment, init_distributed must not raise
    and must leave the process single-controller."""
    import jax

    from emosaic_tpu.parallel.distributed import init_distributed, is_multiprocess

    for k in (
        "EMOSAIC_COORDINATOR",
        "EMOSAIC_NUM_PROCESSES",
        "EMOSAIC_PROCESS_ID",
    ):
        assert k not in os.environ, f"{k} set in the test env"
    init_distributed()
    assert not is_multiprocess()
    assert jax.process_count() == 1
