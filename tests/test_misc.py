"""Modes, monitor, and small utility coverage."""

import time

import pytest

from emosaic_tpu.modes import MODE_TO_N, Mode
from emosaic_tpu.monitor import MemoryMonitor, get_current_rss_kb


def test_mode_table():
    # src/main.rs:400-413 monomorphization table
    assert MODE_TO_N == {
        "1": 1, "2": 4, "3": 9, "4": 16, "5": 25, "6": 36,
        "8": 64, "16": 256, "32": 1024, "64": 4096, "128": 16384,
    }
    assert Mode.M2.dim == 2
    assert Mode.M128.n_cells == 16384
    assert Mode.M32.label == "32x32 (N=1024)"
    assert Mode.RANDOM.label == "Random"
    with pytest.raises(ValueError):
        Mode.RANDOM.n_cells


def test_memory_monitor():
    rss = get_current_rss_kb()
    assert rss is not None and rss > 1000  # Linux /proc path
    m = MemoryMonitor().start()
    time.sleep(0.25)
    m.stop()
    assert float(m.peak_mb()) > 1.0


def test_make_mesh():
    import jax
    from emosaic_tpu.parallel import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    m = make_mesh(8, model=2)
    assert m.shape == {"data": 4, "model": 2}
    m1 = make_mesh(4)
    assert m1.shape == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(6, model=4)


def test_main_module_entry(tmp_path, monkeypatch):
    # `python -m emosaic_tpu` surface exists
    import emosaic_tpu.__main__  # noqa: F401


def test_profile_flag_writes_trace(tmp_path, monkeypatch, rng):
    """--profile DIR captures a jax.profiler trace of the run."""
    import numpy as np
    from PIL import Image

    from emosaic_tpu.cli import main

    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.chdir(tmp_path)
    tiles = tmp_path / "tiles"
    tiles.mkdir()
    for i in range(4):
        arr = rng.integers(0, 256, size=(20, 20, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tiles / f"t{i}.jpg", quality=95)
    src = rng.integers(0, 256, size=(4, 4, 3), dtype=np.uint8)
    Image.fromarray(src).save(tmp_path / "s.png")
    prof = tmp_path / "prof"
    rc = main(
        ["-s", "8", "-o", str(tmp_path / "o.png"), "--profile", str(prof),
         str(tmp_path / "s.png"), "mosaic", str(tiles), "-m", "1"]
    )
    assert rc == 0
    # jax.profiler writes plugins/profile/<ts>/*.trace.json.gz (or .pb)
    traces = list(prof.rglob("*"))
    assert any(p.is_file() for p in traces), traces


def test_phase_timer_and_progress(capsys):
    from emosaic_tpu.monitor import PhaseTimer, Progress

    msgs = []
    t = PhaseTimer(log=lambda *a: msgs.append(" ".join(map(str, a))))
    with t.phase("alpha"):
        time.sleep(0.01)
    with t.phase("beta"):
        pass
    t.report()
    joined = "\n".join(msgs)
    assert "alpha" in joined and "beta" in joined

    # Progress appends "pos/total (rate/s)" to the message
    # (the reference's indicatif {pos}/{len} ({per_sec}) analogue)
    p = Progress(10, "Analysing", interval=0.0)
    p(3)
    p(10)
    err = capsys.readouterr().err
    assert "Analysing 3/10" in err and "10/10" in err and "/s)" in err


def test_print_runtime_stats_format():
    from emosaic_tpu.monitor import MemoryMonitor, print_runtime_stats

    m = MemoryMonitor().start()
    time.sleep(0.05)
    m.stop()
    lines = []
    print_runtime_stats(time.time() - 1.5, m, log=lambda *a: lines.append(a))
    joined = " ".join(str(x) for ln in lines for x in ln)
    assert "Total execution time" in joined
    assert "Peak memory usage" in joined


def test_device_memory_stats_parse(monkeypatch):
    """get_device_memory_stats normalises the XLA allocator counters and
    skips devices without them (the CPU backend returns None)."""
    import jax

    from emosaic_tpu import monitor

    class _Dev:
        def __init__(self, name, ms):
            self._name, self._ms = name, ms

        def __str__(self):
            return self._name

        def memory_stats(self):
            if isinstance(self._ms, Exception):
                raise self._ms
            return self._ms

    devs = [
        _Dev("gpu_0", {"bytes_in_use": 5 << 20, "peak_bytes_in_use": 7 << 20,
                       "bytes_limit": 16 << 30}),
        _Dev("CPU_0", None),          # CPU backend: no counters
        _Dev("gpu_1", {"bytes_in_use": 3 << 20}),  # no peak key -> falls back
        _Dev("BAD_0", RuntimeError("boom")),       # raising device skipped
    ]
    monkeypatch.setattr(jax, "local_devices", lambda: devs)
    stats = monitor.get_device_memory_stats()
    assert [s["device"] for s in stats] == ["gpu_0", "gpu_1"]
    assert stats[0]["peak_bytes_in_use"] == 7 << 20
    assert stats[0]["bytes_limit"] == 16 << 30
    assert stats[1]["peak_bytes_in_use"] == 3 << 20  # bytes_in_use fallback
    assert stats[1]["bytes_limit"] == 0

    # All-None device list -> None (the report omits the section entirely)
    monkeypatch.setattr(jax, "local_devices", lambda: [_Dev("CPU_0", None)])
    assert monitor.get_device_memory_stats() is None


def test_print_runtime_stats_device_memory(monkeypatch):
    """The runtime report prints a per-device HBM line when the backend
    exposes allocator counters, with the limit only when known."""
    from emosaic_tpu import monitor

    monkeypatch.setattr(
        monitor,
        "get_device_memory_stats",
        lambda: [
            {"device": "gpu_0", "bytes_in_use": 1 << 20,
             "peak_bytes_in_use": 2 << 20, "bytes_limit": 16 << 30},
            {"device": "gpu_1", "bytes_in_use": 1 << 20,
             "peak_bytes_in_use": 3 << 20, "bytes_limit": 0},
        ],
    )
    m = monitor.MemoryMonitor().start()
    m.stop()
    lines = []
    monitor.print_runtime_stats(
        time.time() - 1.5, m, log=lambda *a: lines.append(" ".join(map(str, a)))
    )
    joined = "\n".join(lines)
    assert "Device memory [gpu_0]: peak 2.0 MB / 16384 MB limit" in joined
    assert "Device memory [gpu_1]: peak 3.0 MB" in joined
    assert "gpu_1]: peak 3.0 MB / " not in joined  # no limit printed when 0
