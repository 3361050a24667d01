"""Driver entry points stay green: entry() compiles + runs, and the
multi-chip dry run executes on the virtual CPU mesh."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest


@pytest.fixture(scope="module")
def graft():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", Path(__file__).parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_compiles_and_runs(graft):
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (64 * 16, 64 * 16 * 3)  # 2D boundary (layout rule)
    assert out.dtype == np.uint8


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip(graft, n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")
    graft.dryrun_multichip(n)


def test_dryrun_multichip_self_provisions(graft):
    """dryrun_multichip(8) on a one-card host: when the parent backend is
    too small, the entry point must spawn a virtual n-device CPU mesh in
    a subprocess rather than fail."""
    graft._dryrun_multichip_subprocess(8)


def test_devices_if_safe_cpu_pinned(graft):
    """Under the test env (jax_platforms pinned to cpu by conftest) the
    safe probe must return the virtual devices — the in-process branch."""
    devs = graft._devices_if_safe()
    assert devs is not None and len(devs) >= 8


def test_dryrun_never_inits_unsafe_backend(graft, monkeypatch):
    """When the backend cannot be probed without initializing an
    accelerator (which would take the card's memory), dryrun_multichip
    must go straight to the subprocess path without calling
    jax.devices() in the parent."""
    called = []
    monkeypatch.setattr(graft, "_devices_if_safe", lambda: None)
    monkeypatch.setattr(
        graft, "_dryrun_multichip_subprocess", lambda n: called.append(n)
    )
    graft.dryrun_multichip(8)
    assert called == [8]


def test_entry_selections_match_library(graft):
    # the flagship forward must reproduce an exact-match source: feed a
    # source made of tile-average colors and verify low distance visually
    # via the composed output shape only (cheap smoke; full parity is in
    # test_render.py)
    fn, args = graft.entry()
    out = np.asarray(jax.jit(fn)(*args))
    assert out.any()  # non-degenerate output
