"""Kernel accuracy checks (:mod:`katsdpimager_tpu.accuracy`), the
platform choices and the GPU smoke script's plumbing.

The ``gpu``-marked tests run the checks at real widths (K=60, oversample
8, 32 W planes, 4k pixels) on the card and skip elsewhere; the rest run
the same checks at small sizes on the CPU.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from katsdpimager_tpu import accuracy, compile_cache, native
from katsdpimager_tpu.ops import mxu_gridder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Assemblies that meet the 5e-7 grid gate (the CPU's "fft" phase ramps
#: are evaluated in float32 and miss it).
GATED = ["tapdict", "matmul", "tapsmm", "onehot", "joint"]


@pytest.fixture(scope="module")
def small_work():
    return {P: accuracy.make_workload(256, P, 4000, kernel_width=16,
                                      w_planes=4)
            for P in (1, 2)}


@pytest.mark.parametrize("pols", [1, 2])
@pytest.mark.parametrize("assembly", GATED)
def test_grid_check_cpu(small_work, assembly, pols):
    err, rep = accuracy.check_grid(small_work[pols], assembly, ts=32)
    assert err.ok, err.line()
    assert rep.error == 0.0    # the CPU sums in a fixed order


@pytest.mark.parametrize("assembly", GATED)
def test_degrid_check_cpu(small_work, assembly):
    check = accuracy.check_degrid(small_work[2], assembly, ts=32)
    assert check.ok, check.line()


def test_fft_checks_cpu(small_work):
    checks = accuracy.check_fft(small_work[2])
    assert all(c.ok for c in checks), [c.line() for c in checks]


def test_predict_check_cpu():
    check = accuracy.check_predict(n_vis=4096, n_sources=32, pixels=512)
    assert check.ok, check.line()


def test_check_detects_wrong_kernel(small_work):
    """A one-tap shift of the kernel table is caught by the grid gate."""
    work = small_work[1]
    shifted = accuracy.Workload(**{**work.__dict__,
                                   "kernel": np.roll(work.kernel, 1, -1)})
    p = accuracy.plan(work, ts=32)
    good = accuracy.grid_f32(work, p, "tapdict", ts=32)
    bad = accuracy.grid_f32(shifted, p, "tapdict", ts=32)
    assert float(accuracy._max_rel(bad, good)) > 1e3 * accuracy.GRID_TOL


def test_check_line():
    line = accuracy.Check("x", 1e-7, 5e-7, extra={"n": 3}).line()
    assert "error=1.000e-07" in line and "ok" in line and "n=3" in line
    assert "FAIL" in accuracy.Check("y", 1e-6, 5e-7).line()


@pytest.mark.parametrize("platform, assembly, mode", [
    ("cpu", "fft", "scan"),
    ("gpu", mxu_gridder.GPU_ASSEMBLY, mxu_gridder.GPU_MODE),
])
def test_platform_defaults(platform, assembly, mode):
    assert mxu_gridder.default_assembly(platform) == assembly
    assert mxu_gridder._MODE[mxu_gridder.supported_platform(platform)] == mode
    assert assembly in GATED + ["fft"]


def test_unknown_platform_raises():
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        mxu_gridder.default_assembly("metal")


@pytest.mark.parametrize("env", [None, "/some/where/cache"])
def test_compile_cache_dir(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.cache_dir() == os.path.join(ROOT, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert compile_cache.cache_dir() == env


def test_native_key_tracks_source_and_cpu(tmp_path):
    """A library built from other source, or for another CPU, has another
    file name, so it is never loaded: the first use rebuilds."""
    src = tmp_path / "preprocess.cpp"
    shutil.copy(native._SRC, src)
    key = native.build_key(str(src), cpu="model name: A\nflags: x")
    assert native.build_key(str(src), cpu="model name: A\nflags: x") == key
    assert native.build_key(str(src), cpu="model name: B\nflags: x") != key
    src.write_text(src.read_text() + "\n// edited\n")
    assert native.build_key(str(src), cpu="model name: A\nflags: x") != key
    assert os.path.basename(native.library_path(key)) == \
        f"libktpu_native-{key}.so"


def test_native_library_lives_in_build_dir():
    path = native.library_path()
    assert path.startswith(native.BUILD_DIR)
    assert native.available()
    assert os.path.exists(path)


def test_brightest_sources():
    sys.path.insert(0, ROOT)
    import chip_smoke

    img = np.zeros((200, 200))
    for (y, x), v in zip([(20, 30), (100, 100), (150, 40), (60, 170)],
                         [1.0, 1.5, 1.2, 1.4]):
        img[y, x] = v
        img[y, x + 1] = 0.9 * v     # a neighbour is not a second source
    assert chip_smoke.brightest_sources(img) == [1.5, 1.4, 1.2, 1.0]


def test_chip_smoke_fails_without_gpu():
    """On the CPU the smoke script exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied away from the package, the script exits non-zero."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def card_work():
    return {P: accuracy.make_workload(4096, P, 1 << 17) for P in (1, 4)}


@pytest.mark.gpu
@pytest.mark.parametrize("pols", [1, 4])
def test_grid_and_degrid_on_card(gpu, card_work, pols):
    err, rep = accuracy.check_grid(card_work[pols])
    assert err.ok, err.line()
    assert rep.ok, rep.line()
    check = accuracy.check_degrid(card_work[pols])
    assert check.ok, check.line()


@pytest.mark.gpu
def test_fft_on_card(gpu, card_work):
    checks = accuracy.check_fft(card_work[4])
    assert all(c.ok for c in checks), [c.line() for c in checks]


@pytest.mark.gpu
def test_predict_on_card(gpu):
    check = accuracy.check_predict()
    assert check.ok, check.line()


@pytest.mark.gpu
def test_default_assembly_on_card(gpu):
    assert mxu_gridder.default_assembly() == mxu_gridder.GPU_ASSEMBLY


def _trace_dir(tmp_path, name="gpu_trace.xplane.pb"):
    d = tmp_path / "trace" / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, "tests", "data", name), d / "x.xplane.pb")
    return str(tmp_path / "trace")


def test_gpu_trace_reduction(tmp_path):
    """A trace recorded on an H100 (one jitted matmul + FFT + reductions):
    the kernels of its stream line, each counted once."""
    from katsdpimager_tpu import profiling

    totals = profiling.parse_device_profile(_trace_dir(tmp_path),
                                            platform="gpu")
    assert {line for line, _ in totals} == {"Stream #13(Compute)"}
    names = [name for _, name in totals]
    assert len(names) == 6
    assert any("gemm" in n for n in names)
    assert sum("fft" in n for n in names) == 2
    assert abs(sum(totals.values()) - 12.127e-6) < 1e-9


@pytest.mark.parametrize("line, kept", [
    ("Stream #13(Compute)", True),
    ("Stream #14(MemcpyH2D)", True),
    ("XLA Ops", False),
    ("XLA Modules", False),
])
def test_kernel_lines(line, kept):
    from katsdpimager_tpu import profiling

    assert profiling._kernel_line(line) is kept


def test_accelerator_trace_without_device_plane_raises(tmp_path):
    import jax
    import jax.numpy as jnp

    from katsdpimager_tpu import profiling

    d = str(tmp_path / "cpu_trace")
    with profiling.device_trace(d):
        jax.jit(lambda x: x * 2)(jnp.ones(8)).block_until_ready()
    assert profiling.parse_device_profile(d, platform="cpu")
    with pytest.raises(RuntimeError, match="no device plane"):
        profiling.parse_device_profile(d, platform="gpu")
