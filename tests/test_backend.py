"""Capability routing (ops/backend.py): the dispatch table, the device
memory budgets, the compile-cache location, and the f32-dot audit."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import emosaic_tpu
from emosaic_tpu.ops import backend, composite, distance

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "plat,d,span,route",
    [
        ("cpu", 12, 0, "xla"),
        ("cpu", 192, 0, "xla"),
        ("cpu", 3072, 0, "xla"),
        ("cpu", 12, 2**40, "xla"),
        ("gpu", 12, 0, "triton"),
        ("gpu", 48, 2**31 - 1, "triton"),
        ("gpu", 256, 0, "triton"),
        ("gpu", 12, 2**31, "xla"),  # past the kernel's 32-bit offsets
        ("gpu", 192, 2**33, "xla"),
        ("gpu", 257, 0, "adaptive"),
        ("gpu", 768, 0, "adaptive"),
        ("gpu", 768, 2**33, "adaptive"),  # the span is the kernel's alone
        ("gpu", 769, 0, "xla"),
        ("gpu", 3072, 0, "xla"),
    ],
)
def test_argmin_route_table(plat, d, span, route):
    assert backend.argmin_route(plat, d, span) == route


BIG = 16384 * 65534  # flagship B * L


@pytest.mark.parametrize(
    "plat,d,elems,route",
    [
        ("cpu", 3072, 10**7, "adaptive"),  # small shapes: always tried
        ("gpu", 3072, 10**7, "adaptive"),
        ("cpu", 256, BIG, "adaptive"),
        ("cpu", 257, BIG, "twolevel"),
        ("cpu", 768, BIG, "twolevel"),
        ("gpu", 192, BIG, "adaptive"),
        ("gpu", 257, BIG, "adaptive"),
        ("gpu", 768, BIG, "adaptive"),  # measured at k = 1 and k = 512
        ("gpu", 769, BIG, "twolevel"),
        ("gpu", 3072, BIG, "twolevel"),
        ("gpu", 3072, 10**7 + 1, "twolevel"),
    ],
)
def test_topk_route_table(plat, d, elems, route):
    assert backend.topk_route(plat, d, elems) == route


def test_ad_plan_follows_topk_route(monkeypatch):
    """`_ad_plan`'s scale gate is the route table's: an eligible flagship
    shape turns ineligible when the table says two-level."""
    b, l = 16384, 65534
    assert distance._ad_plan(b, l, 48, 512)[0]
    assert not distance._ad_plan(b, l, 768, 512)[0]
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert distance._ad_plan(b, l, 768, 512)[0]
    assert not distance._ad_plan(b, l, 3072, 512)[0]
    monkeypatch.setitem(backend.ADAPTIVE_MAX_D, "gpu", 32)
    assert not distance._ad_plan(b, l, 48, 512)[0]


@pytest.mark.parametrize("plat", ["rocm", "metal", ""])
def test_unknown_platform_raises(plat):
    with pytest.raises(backend.UnsupportedPlatform):
        backend.argmin_route(plat, 12)
    with pytest.raises(backend.UnsupportedPlatform):
        backend.topk_route(plat, 12, BIG)


def test_l1_argmin_raises_on_unknown_platform(monkeypatch, rng):
    monkeypatch.setattr(backend, "platform", lambda: "rocm")
    x = rng.integers(0, 256, (4, 12), dtype=np.uint8)
    with pytest.raises(backend.UnsupportedPlatform):
        distance.l1_argmin(x, x)


@pytest.mark.parametrize(
    "b,l,d", [(29, 77, 48), (1, 5, 12), (0, 5, 12), (40, 300, 768)]
)
def test_l1_argmin_cpu_route_equals_brute_force(rng, b, l, d):
    blocks = rng.integers(0, 256, (b, d), dtype=np.uint8)
    lib = rng.integers(0, 256, (l, d), dtype=np.uint8)
    full = np.abs(
        blocks.astype(np.int64)[:, None] - lib.astype(np.int64)[None]
    ).sum(-1)
    d, r = distance.l1_argmin(blocks, lib)
    np.testing.assert_array_equal(np.asarray(d), full.min(1))
    np.testing.assert_array_equal(np.asarray(r), full.argmin(1))


def test_l1_argmin_oversized_operands_skip_triton(monkeypatch, rng):
    """On a GPU, an input past the Triton kernel's 32-bit offsets takes the
    scan (limit lowered to a test size; the scan runs on the CPU here)."""
    blocks = rng.integers(0, 256, (40, 12), dtype=np.uint8)
    lib = rng.integers(0, 256, (300, 12), dtype=np.uint8)
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    monkeypatch.setattr(backend, "TRITON_INDEX_LIMIT", 1000)

    def no_triton(*a, **k):
        raise AssertionError("Triton kernel reached past its offset limit")

    monkeypatch.setattr(distance, "l1_argmin_triton", no_triton)
    d, r = distance.l1_argmin(blocks, lib)
    ref_d, ref_r = distance.l1_argmin_xla(blocks, lib)
    np.testing.assert_array_equal(np.asarray(d), np.asarray(ref_d))
    np.testing.assert_array_equal(np.asarray(r), np.asarray(ref_r))


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_budgets_follow_bytes_limit(monkeypatch):
    monkeypatch.delenv("EMOSAIC_DEVICE_LIB_BYTES", raising=False)
    dev = _FakeDevice({"bytes_limit": 80_000, "bytes_in_use": 5})
    assert backend.bytes_limit(dev) == 80_000
    assert backend.device_lib_bytes(dev) == int(80_000 * backend.LIB_FRACTION)
    assert backend.device_stack_bytes(dev) == int(
        80_000 * backend.STACK_FRACTION
    )


def test_lib_budget_env_override(monkeypatch):
    monkeypatch.setenv("EMOSAIC_DEVICE_LIB_BYTES", "123456")
    assert backend.device_lib_bytes(_FakeDevice({"bytes_limit": 10})) == 123456


def test_bytes_limit_without_stats_is_host_memory():
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert backend.bytes_limit(_FakeDevice(None)) == host
    assert backend.bytes_limit(_FakeDevice({})) == host


def test_distance_budget_derived_unless_pinned(monkeypatch):
    monkeypatch.setattr(distance, "_DEVICE_LIB_BYTES_MAX", None)
    monkeypatch.setenv("EMOSAIC_DEVICE_LIB_BYTES", "4242")
    assert distance._lib_budget() == 4242
    monkeypatch.setattr(distance, "_DEVICE_LIB_BYTES_MAX", 77)
    assert distance._lib_budget() == 77


def test_serve_and_cli_stack_cap_default_to_device(monkeypatch):
    from emosaic_tpu import cli

    monkeypatch.setattr(backend, "device_stack_bytes", lambda device=None: 0)

    class _TS:
        def __len__(self):
            return 3

    assert cli.get_image_stack(_TS(), Path("."), 8) is None  # over the cap


def test_compile_cache_dir_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert emosaic_tpu.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert emosaic_tpu.compile_cache_dir() == str(REPO / ".jax_cache")


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_configured_at_import(tmp_path, env_set):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "EMOSAIC_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(REPO / ".jax_cache")
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = want = str(tmp_path / "cc")
    out = subprocess.run(
        [sys.executable, "-c",
         "import emosaic_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want


def _dots(jaxpr):
    """Every dot_general equation in a jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _dots(inner)


def test_no_f32_dot_at_default_precision():
    """A GPU runs an f32-operand dot at default precision in TF32 (about
    three decimal digits). Every dot in the matcher and composite jits
    must either take bf16/integer operands or ask for HIGHEST."""
    b, l, d = 8, 256, 48
    bf = jnp.zeros((b * d,), jnp.uint8)
    lf = jnp.zeros((l * d,), jnp.uint8)
    cl = jnp.zeros((l, d // 4), jnp.int32)  # g=4 per-channel groups
    progs = [
        jax.make_jaxpr(lambda x, y: distance._l1_argmin_stripes_jit(
            x, y, d=d, bc=8, real_l=l))(bf, lf),
        jax.make_jaxpr(lambda x, y: distance._l1_topk_twolevel_jit(
            x, y, d=d, bc=8, k=4, real_l=l, cap=8))(bf, lf),
        jax.make_jaxpr(lambda x, y: distance._ad_coarse_core_jit(
            x, y, d=d, g=4, chan=True, bc=8, cap=4, real_l=l))(bf, cl),
        jax.make_jaxpr(lambda x, y: distance._ad_proj_bank_jit(
            y, d=d, g=4, chan=True))(bf, lf),
        jax.make_jaxpr(lambda x, y: distance._l2_prefilter_jit(
            x, y, d=d, bc=8, k_pre=16))(bf, lf),
        jax.make_jaxpr(lambda x, y: distance._l2_argmin_jit(
            x, y, d=d, bc=8, real_l=l))(bf, lf),
        jax.make_jaxpr(lambda i, a: composite._compose_rows_xla(
            i, a, ts=4))(jnp.zeros((2, 3), jnp.int32),
                         jnp.zeros((9, 4, 12), jnp.uint8)),
    ]
    found = 0
    for closed in progs:
        for eqn in _dots(closed.jaxpr):
            found += 1
            dtypes = {v.aval.dtype for v in eqn.invars}
            prec = eqn.params.get("precision")
            highest = prec is not None and all(
                p == jax.lax.Precision.HIGHEST for p in prec
            )
            assert jnp.float32 not in dtypes or highest, eqn
    assert found >= 3  # the audit saw the bf16 projection/prefilter dots
