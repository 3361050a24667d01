"""Runtime observability: RSS memory monitor + wall-time stats
(reference: src/main.rs:157-269) and a throughput progress printer
(the reference's indicatif bars, main.rs:751-757, rendering.rs:60-66).
"""

from __future__ import annotations

import sys
import threading
import time


def get_current_rss_kb() -> int | None:
    """VmRSS from /proc/self/status (main.rs:233-245)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


class MemoryMonitor:
    """Background thread sampling peak RSS every 100ms (main.rs:157-216)."""

    def __init__(self):
        self._peak_kb = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "MemoryMonitor":
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            rss = get_current_rss_kb()
            if rss is not None and rss > self._peak_kb:
                self._peak_kb = rss
            self._stop.wait(0.1)

    def stop(self):
        self._stop.set()

    def peak_mb(self) -> str:
        return f"{self._peak_kb / 1024.0:.1f}" if self._peak_kb else "N/A"


def get_device_memory_stats() -> list[dict] | None:
    """Per-device HBM usage from the XLA allocator.

    The device-side analogue of the reference's RSS sampling
    (main.rs:157-216): /proc RSS cannot see device HBM, so the runtime
    report also surfaces the backend allocator's own counters
    (current/peak bytes in use, device limit). Returns None on backends
    that don't expose them — the CPU backend's ``memory_stats()`` is
    None, so CI runs simply omit the section.
    """
    try:
        import jax

        devices = jax.local_devices()
    except Exception:
        return None
    out = []
    for d in devices:
        try:
            ms = d.memory_stats()
        except Exception:
            ms = None
        if not ms:
            continue
        in_use = int(ms.get("bytes_in_use", 0))
        out.append(
            {
                "device": str(d),
                "bytes_in_use": in_use,
                "peak_bytes_in_use": int(ms.get("peak_bytes_in_use", in_use)),
                "bytes_limit": int(ms.get("bytes_limit", 0)),
            }
        )
    return out or None


def print_runtime_stats(start_time: float, monitor: MemoryMonitor, log=None):
    """main.rs:253-269 (+ device HBM counters, which the CUDA-less
    reference has no analogue for)."""
    log = log or (lambda *a: print(*a, file=sys.stderr))
    total = time.time() - start_time
    log("📊 Runtime Statistics:")
    log(f"   Total execution time: {total:.2f}s")
    if total >= 60.0:
        log(f"   ({int(total // 60)} min {total % 60.0:.1f}s)")
    if total >= 1.0:
        log(f"   Peak memory usage: {monitor.peak_mb()} MB")
        for s in get_device_memory_stats() or []:
            line = (
                f"   Device memory [{s['device']}]: "
                f"peak {s['peak_bytes_in_use'] / 2**20:.1f} MB"
            )
            if s["bytes_limit"]:
                line += f" / {s['bytes_limit'] / 2**20:.0f} MB limit"
            log(line)


class PhaseTimer:
    """Per-phase wall timers printed at exit — the device-side analogue of the
    reference's per-stage progress throughput (SURVEY.md section 5
    'tracing/profiling')."""

    def __init__(self, log=None):
        self.log = log or (lambda *a: print(*a, file=sys.stderr))
        self.phases: list[tuple[str, float]] = []

    class _Span:
        def __init__(self, timer, name):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.time()
            return self

        def __exit__(self, *exc):
            self.timer.phases.append((self.name, time.time() - self.t0))
            return False

    def phase(self, name: str) -> "_Span":
        return PhaseTimer._Span(self, name)

    def report(self):
        if not self.phases:
            return
        self.log("⏱  Phase timings:")
        for name, dt in self.phases:
            self.log(f"   {name}: {dt:.2f}s")


class Progress:
    """Minimal throughput progress line (stderr), standing in for the
    reference's indicatif `{msg} {wide_bar} {pos}/{len} ({per_sec})`."""

    def __init__(self, total: int, message: str, interval: float = 1.0):
        self.total = total
        self.message = message
        self.start = time.time()
        self._last = 0.0
        self.interval = interval

    def __call__(self, pos: int, total: int | None = None):
        now = time.time()
        total = total or self.total
        if now - self._last < self.interval and pos < total:
            return
        self._last = now
        rate = pos / max(now - self.start, 1e-9)
        print(
            f"\r{self.message} {pos}/{total} ({rate:.0f}/s)",
            end="\n" if pos >= total else "",
            file=sys.stderr,
        )
