"""Benchmark suite: the reference's metrics (tests/imager_bench.py) plus
the BASELINE's targets, one JSON line per benchmark, on an NVIDIA GPU.

Benchmarks:

- ``preprocess``: Mvis/s through the native C++ collector and the JAX path
  (reference imager_bench.py:149-163 prints the same units);
- ``grid``/``degrid``: GGAPS = N_vis * kernel_width^2 * n_pols / t
  (reference imager_bench.py:166-208);
- ``fft``: GiB/s = pixels^2 * 8 B * 4 accesses / t (imager_bench.py:211-229);
- ``clean``: minor-cycle iterations/s, fully on device (BASELINE metric);
- ``channels``: channels/s through the multi-channel sharded step
  (BASELINE 512-channel cube metric, scaled to available devices).

Run: ``python benchmarks/bench_suite.py [names...]`` (defaults to all).
Each line names the device (``bench.device_info``); each timing ends in
``block_until_ready``.  Fails without a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

# Allow running as `python benchmarks/bench_suite.py` without install.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from bench import device_info  # noqa: E402
from katsdpimager_tpu.compile_cache import enable_compilation_cache  # noqa: E402

_DEVICE = None


def _time(fn, *args, iters=3):
    """Seconds per call after a warm-up, each call ended by
    block_until_ready."""
    jax.block_until_ready(fn(*args))
    start = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - start) / iters


def _report(**kwargs):
    print(json.dumps(dict(kwargs, device=_DEVICE)))


def bench_preprocess():
    from katsdpimager_tpu import native, polarization
    from katsdpimager_tpu.preprocess import (ChannelGeometry,
                                             _preprocess_channel)

    geom = ChannelGeometry(pixels=8192, cell_size=10.0, oversample=8,
                           w_slices=8, w_planes=32, max_w=8000.0,
                           kernel_width=60)
    n = 1 << 21
    rng = np.random.default_rng(0)
    uvw = rng.uniform(-4000, 4000, size=(n, 3)).astype(np.float32)
    vis = (rng.normal(size=(n, 4)) + 1j * rng.normal(size=(n, 4))
           ).astype(np.complex64)
    wt = rng.uniform(0.5, 2.0, size=(n, 4)).astype(np.float32)
    mueller = polarization.polarization_matrix(
        polarization.STOKES_IQUV,
        [polarization.STOKES_XX, polarization.STOKES_XY,
         polarization.STOKES_YX, polarization.STOKES_YY])

    if native.available():
        native.preprocess_channel(uvw[:1000], wt[:1000], vis[:1000],
                                  mueller, geom)
        start = time.perf_counter()
        native.preprocess_channel(uvw, wt, vis, mueller, geom)
        dt = time.perf_counter() - start
        _report(metric="preprocess_native", value=round(n / dt / 1e6, 2),
                unit="Mvis/s", num_vis=n)

    uvw_j, wt_j = jnp.asarray(uvw), jnp.asarray(wt)
    vis_j = jnp.asarray(vis)
    m_j = jnp.asarray(np.asarray(mueller))

    def run(uvw, wt, vis):
        return _preprocess_channel(geom, 4, uvw, wt, vis, m_j)

    dt = _time(run, uvw_j, wt_j, vis_j)
    _report(metric="preprocess_jax", value=round(n / dt / 1e6, 2),
            unit="Mvis/s", num_vis=n)


def _grid_setup():
    from katsdpimager_tpu.ops import mxu_gridder, wkernel

    pixels, K, n = 4096, 60, 1 << 20
    oversample, w_planes = 8, 32
    rng = np.random.default_rng(1)
    kernel = (rng.normal(size=(w_planes, oversample, K))
              + 1j * rng.normal(size=(w_planes, oversample, K))
              ).astype(np.complex64)
    lim = pixels // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, oversample, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, w_planes, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, 1)) + 1j * rng.normal(size=(n, 1))
           ).astype(np.complex64)
    wts = np.ones((n, 1), np.float32)
    g = mxu_gridder.MxuGridder(pixels=pixels, kernel_width=K, num_pols=1,
                               rv=64, ru=64, mc=256)
    plan = g.plan(uv, sub, wp, vis, wts)
    vis_np = plan.vis
    plan = g.upload_plan(plan)._replace(vis=vis_np)
    return g, plan, kernel, pixels, K, n


def bench_grid():
    g, plan, kernel, pixels, K, n = _grid_setup()
    wg = jnp.ones((1, pixels, pixels), jnp.float32)
    kern = jnp.asarray(kernel)
    zero = jnp.zeros((1, pixels, pixels), jnp.complex64)
    visc = jnp.asarray(plan.vis)

    def run():
        return g.grid(zero, kern, wg, plan, vis_chunked=visc)

    dt = _time(run)
    _report(metric="grid", value=round(n * K * K / dt / 1e9, 2),
            unit="GGAPS", mvis_per_s=round(n / dt / 1e6, 2),
            num_vis=n, kernel_width=K, pixels=pixels)


def bench_degrid():
    g, plan, kernel, pixels, K, n = _grid_setup()
    rng = np.random.default_rng(2)
    grid = (rng.normal(size=(1, pixels, pixels))
            + 1j * rng.normal(size=(1, pixels, pixels))).astype(np.complex64)
    grid_j = jnp.asarray(grid)
    kern = jnp.asarray(kernel)
    visc = jnp.asarray(plan.vis)

    def run():
        return g.degrid(grid_j, kern, plan, visc)

    dt = _time(run)
    _report(metric="degrid", value=round(n * K * K / dt / 1e9, 2),
            unit="GGAPS", mvis_per_s=round(n / dt / 1e6, 2),
            num_vis=n, kernel_width=K, pixels=pixels)


def bench_fft():
    pixels = 8192
    rng = np.random.default_rng(3)
    grid = (rng.normal(size=(pixels, pixels))
            + 1j * rng.normal(size=(pixels, pixels))).astype(np.complex64)
    grid_j = jnp.asarray(grid)
    fn = jax.jit(lambda g: jnp.fft.ifft2(g))
    dt = _time(fn, grid_j)
    gib = pixels * pixels * 8 * 4 / dt / 2 ** 30
    _report(metric="fft", value=round(gib, 2), unit="GiB/s", pixels=pixels)


def bench_clean():
    from katsdpimager_tpu.ops import clean as clean_ops

    pixels = 8192
    pols = 1
    rng = np.random.default_rng(4)
    dirty = rng.normal(size=(pols, pixels, pixels)).astype(np.float32)
    patch = 257
    psf = rng.normal(scale=0.01, size=(pols, patch, patch)).astype(np.float32)
    psf[:, patch // 2, patch // 2] = 1.0
    cfg = clean_ops.CleanConfig(pixels=pixels, num_pols=pols,
                                border_pixels=0, patch_y=patch,
                                patch_x=patch, mode=clean_ops.CLEAN_I,
                                loop_gain=0.1)
    state = clean_ops.make_state(cfg, jnp.asarray(dirty),
                                 jnp.zeros_like(jnp.asarray(dirty)))
    iters = 1024
    psf_j = jnp.asarray(psf)

    def run(state):
        out = clean_ops.minor_cycles(cfg, state, psf_j,
                                     jnp.float32(0.0), iters)
        return out[0]

    dt = _time(run, state, iters=1)
    _report(metric="clean", value=round(iters / dt, 1), unit="iters/s",
            pixels=pixels, patch=patch, minor=iters)


def bench_channels():
    from katsdpimager_tpu.parallel import (MultiChannelConfig,
                                           make_example_batch,
                                           make_imaging_step, make_mesh)

    n_dev = jax.device_count()
    cfg = MultiChannelConfig(
        pixels=2048, num_pols=1, kernel_width=60, oversample=8,
        w_planes=16, w_slices=2, chunks_per_slice=1024, chunk_size=256,
        rv=64, ru=64, minor_cycles=64, patch=65, loop_gain=0.1)
    mesh = make_mesh(vis_shards=1)
    C = n_dev
    batch = make_example_batch(cfg, C)
    step = make_imaging_step(mesh, cfg)

    def run():
        return step(batch)

    dt = _time(run)
    _report(metric="channels", value=round(C / dt, 2), unit="channels/s",
            num_channels=C, pixels=cfg.pixels, devices=n_dev)


def bench_predict():
    """Direct DFT prediction throughput (reference tests/predict_bench.py:
    visibilities/s for subtracting S point sources)."""
    from katsdpimager_tpu.ops import predict

    n = 1 << 20
    S = 256
    O = 8
    rng = np.random.default_rng(5)
    lmn = jnp.asarray(rng.normal(scale=1e-3, size=(S, 3)).astype(np.float32))
    flux = jnp.asarray(rng.uniform(0.1, 1.0, size=(S, 1)).astype(np.float32))
    uv = jnp.asarray(rng.integers(-1000, 1000, size=(n, 2)).astype(np.int32))
    sub = jnp.asarray(rng.integers(0, O, size=(n, 2)).astype(np.int32))
    wp = jnp.asarray(rng.integers(0, 32, size=n).astype(np.int32))
    weights = jnp.ones((n, 1), jnp.float32)
    vis_np = (rng.normal(size=(n, 1))
              + 1j * rng.normal(size=(n, 1))).astype(np.complex64)

    def run():
        vis = jnp.asarray(vis_np)
        return predict.predict_subtract(
            lmn, flux, uv, sub, wp, vis, weights,
            jnp.float32(1e-4), jnp.float32(0.5), jnp.float32(10.0),
            oversample=O)

    dt = _time(run)
    _report(metric="predict", value=round(n / dt / 1e6, 2), unit="Mvis/s",
            num_vis=n, num_sources=S)


def bench_predict_exact():
    """Exact trig-free prediction for pixel-grid components
    (predict_subtract_exact; the model_predict path)."""
    from katsdpimager_tpu.ops import predict

    n = 1 << 20
    S, O, N = 256, 8, 4096
    W = 32
    rng = np.random.default_rng(5)
    xi = jnp.asarray(rng.integers(-N // 4, N // 4, S).astype(np.int32))
    yi = jnp.asarray(rng.integers(-N // 4, N // 4, S).astype(np.int32))
    pix = 1.0 / (N * O * 1e-4)
    l = np.asarray(xi) * pix
    m = np.asarray(yi) * pix
    n1 = jnp.asarray((np.sqrt(np.maximum(1 - l * l - m * m, 0)) - 1
                      ).astype(np.float32))
    flux = jnp.asarray(rng.uniform(0.1, 1.0, size=(S, 1)).astype(np.float32))
    uv = jnp.asarray(rng.integers(-1000, 1000, size=(n, 2)).astype(np.int32))
    sub = jnp.asarray(rng.integers(0, O, size=(n, 2)).astype(np.int32))
    wp = jnp.asarray(rng.integers(0, W, size=n).astype(np.int32))
    weights = jnp.ones((n, 1), jnp.float32)
    vis_np = (rng.normal(size=(n, 1))
              + 1j * rng.normal(size=(n, 1))).astype(np.complex64)

    def run():
        vis = jnp.asarray(vis_np)
        return predict.predict_subtract_exact(
            xi, yi, n1, flux, uv, sub, vis, weights, wp,
            jnp.float32(0.5), jnp.float32(10.0), pixels=N, oversample=O,
            w_planes=W)

    dt = _time(run)
    _report(metric="predict_exact", value=round(n / dt / 1e6, 2),
            unit="Mvis/s", num_vis=n, num_sources=S)


def bench_step_1slice():
    """The round-2/3 driver-bench workload (w_slices=1), kept as a suite
    twin for cross-round comparability after the driver headline moved
    to the production 4-slice shape (VERDICT r3 item 2)."""
    from bench import run_step_bench
    from katsdpimager_tpu.parallel.multichannel import MultiChannelConfig

    cfg = MultiChannelConfig(
        pixels=4096, num_pols=1, kernel_width=60, oversample=8,
        w_planes=32, w_slices=1, chunks_per_slice=8192, chunk_size=256,
        rv=64, ru=64, minor_cycles=0, weight_type="natural")
    out = run_step_bench(cfg, 8, 1 << 20)
    out["metric"] = "step_1slice"
    del out["device"]
    _report(**out)


ALL = {
    "preprocess": bench_preprocess,
    "grid": bench_grid,
    "degrid": bench_degrid,
    "step_1slice": bench_step_1slice,
    "fft": bench_fft,
    "clean": bench_clean,
    "predict": bench_predict,
    "predict_exact": bench_predict_exact,
    "channels": bench_channels,
}


def main(argv=None):
    global _DEVICE
    enable_compilation_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("bench_suite: needs an NVIDIA GPU")
    _DEVICE = device_info()
    names = (argv or sys.argv[1:]) or list(ALL)
    for name in names:
        ALL[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
