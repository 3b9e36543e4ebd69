"""Accuracy of the device kernels against plain float64 references.

Each check builds a seeded random workload at the given widths, runs the
production float32 kernel on the default device, and compares it with an
independent reference: the scatter formulation (:mod:`.ops.gridder`) run
in float64, numpy's float64 FFT, or a float64 direct DFT.  Each returns a
:class:`Check` holding the error beside the tolerance it is held to.
``chip_smoke.py`` runs them at real widths on the card; the tests run them
at small sizes on the CPU.

Tolerances, and why:

- grid: 5e-7 of the grid peak.  Every output cell is a sum of float32
  products; measured against the float64 oracle both float32 gridders sit
  near 2e-7 (``tests/test_accuracy_gate.py``), so 5e-7 leaves 2x margin
  and still fails a wrong tap, window or TF32 product (~1e-3).
- degrid: 1e-6 of the largest predicted visibility.  Each prediction is a
  K^2-term float32 dot product (3600 terms at K=60) whose rounding grows
  like sqrt(K^2) * 2^-24 relative to the terms.
- grid->image: 1e-4 of the image peak where the normalized taper^2 is at
  least 0.002, and 1e-6 over the central half: the taper division
  amplifies float32 rounding by up to 1/taper^2 toward the corners (the
  gate of ``tests/test_accuracy_gate.py``).
- image->grid: 1e-6 of the grid peak: the model image has its components
  in the central half, where the taper amplifies rounding by at most ~6.
- prediction: the float32 phase of the largest |u l + v m + w (n-1)| (in
  turns) times 8 ulp, relative to the summed component flux — the bound
  on the phase error of any one term, which no sum of terms can exceed.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import parameters, polarization
from .ops import fourier, gridder, mxu_gridder, predict, wkernel

GRID_TOL = 5e-7
DEGRID_TOL = 1e-6
IMAGE_TOL_FIELD = 1e-4
IMAGE_TOL_CENTRE = 1e-6
GRID_FROM_IMAGE_TOL = 1e-6


@dataclasses.dataclass
class Check:
    """One comparison: ``error`` against ``tolerance`` (both relative to
    the reference's scale, see the module docstring)."""

    name: str
    error: float
    tolerance: float
    precision: str = "float32 (matmuls at HIGHEST) vs float64"
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return bool(self.error <= self.tolerance)

    def line(self) -> str:
        more = "".join(f" {k}={v:.3g}" if isinstance(v, float)
                       else f" {k}={v}" for k, v in self.extra.items())
        return (f"{self.name}: error={self.error:.3e} "
                f"tolerance={self.tolerance:.1e} "
                f"{'ok' if self.ok else 'FAIL'} [{self.precision}]{more}")


@dataclasses.dataclass
class Workload:
    """Seeded gridding input at real widths: clustered UV, real W kernels,
    and the visibilities of a few point sources in the central half of the
    field (the shape of a real sky: a peaked image, not noise)."""

    pixels: int
    kernel: np.ndarray     # (W, O, K) complex64
    uv: np.ndarray         # (n, 2) int16 centred cells
    sub_uv: np.ndarray     # (n, 2) int16
    w_plane: np.ndarray    # (n,) int16
    vis: np.ndarray        # (n, P) complex64
    image_p: parameters.ImageParameters
    grid_p: parameters.GridParameters

    @property
    def num_pols(self) -> int:
        return self.vis.shape[1]


def make_workload(pixels: int, num_pols: int, n_vis: int, *,
                  kernel_width: int = 60, oversample: int = 8,
                  w_planes: int = 32, n_sources: int = 8,
                  seed: int = 0) -> Workload:
    rng = np.random.default_rng(seed)
    fixed = parameters.FixedImageParameters(
        (polarization.STOKES_I,) * num_pols)
    fgp = parameters.FixedGridParameters(
        antialias_width=7.0, oversample=oversample, image_oversample=4,
        max_w=1000.0, kernel_width=kernel_width)
    gp = parameters.GridParameters(fgp, 1, w_planes)
    ip = parameters.ImageParameters(fixed, 0.21, pixel_size=1.0 / (pixels * 16),
                                    pixels=pixels)
    kernel = wkernel.make_convolution_kernel(ip, gp).astype(np.complex64)
    lim = pixels // 2 - kernel_width - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n_vis, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, oversample, size=(n_vis, 2)).astype(np.int16)
    wp = rng.integers(0, w_planes, size=n_vis).astype(np.int16)
    cell = ip.cell_size / ip.wavelength          # cell size in wavelengths
    u = (uv[:, 0] + (sub[:, 0] + 0.5) / oversample) * cell
    v = (uv[:, 1] + (sub[:, 1] + 0.5) / oversample) * cell
    field = pixels * ip.pixel_size / 4
    vis = np.zeros((n_vis, num_pols), np.complex128)
    for _ in range(n_sources):
        l, m = rng.uniform(-field, field, 2)
        vis += (rng.uniform(0.1, 1.5, num_pols)[None, :]
                * np.exp(-2j * np.pi * (u * l + v * m))[:, None])
    return Workload(pixels, kernel, uv, sub, wp, vis.astype(np.complex64),
                    ip, gp)


def plan(work: Workload, ts: int = 64, mc: int = 256) -> mxu_gridder.ChunkPlan:
    return mxu_gridder.plan_chunks_tiled(
        work.uv, work.sub_uv, work.w_plane, work.vis,
        np.ones(work.vis.shape, np.float32), pixels=work.pixels,
        kernel_width=work.kernel.shape[-1], ts=ts, mc=mc)


@partial(jax.jit, static_argnames=("pixels", "ts", "assembly"))
def _grid_f32(kernel, uv, sub, wp, vis, anchor, valid, *, pixels, ts,
              assembly):
    ext = mxu_gridder.dense_pad_size(pixels, ts)
    gpad = jnp.zeros((vis.shape[-1], ext, ext), jnp.complex64)
    gpad = mxu_gridder.grid_chunks_dense_impl(
        gpad, kernel, None, uv, sub, wp, vis, anchor, valid, None,
        mxu_gridder.occupied_chunks(valid), pixels=pixels, ts=ts,
        assembly=assembly)
    return gpad[:, :pixels, :pixels]


def grid_f32(work: Workload, p: mxu_gridder.ChunkPlan, assembly: str,
             ts: int = 64) -> jnp.ndarray:
    """The production gridder (natural weighting) on a tile-aligned plan."""
    return _grid_f32(jnp.asarray(work.kernel), jnp.asarray(p.uv),
                     jnp.asarray(p.sub_uv), jnp.asarray(p.w_plane),
                     jnp.asarray(p.vis), jnp.asarray(p.anchor),
                     jnp.asarray(p.valid), pixels=work.pixels, ts=ts,
                     assembly=assembly)


def grid_f64(work: Workload) -> jnp.ndarray:
    """The scatter formulation in float64 (call inside ``enable_x64``)."""
    P, N = work.num_pols, work.pixels
    return gridder.grid_vis(
        jnp.zeros((P, N, N), jnp.complex128),
        jnp.asarray(work.kernel, jnp.complex128),
        jnp.ones((P, N, N), jnp.float64), jnp.asarray(work.uv),
        jnp.asarray(work.sub_uv), jnp.asarray(work.w_plane),
        jnp.asarray(work.vis, jnp.complex128), pixels=N)


@jax.jit
def _max_rel(a, ref):
    return (jnp.max(jnp.abs(a.astype(ref.dtype) - ref))
            / jnp.max(jnp.abs(ref)))


def check_grid(work: Workload, assembly: str | None = None,
               ts: int = 64) -> tuple[Check, Check]:
    """Grid error against the float64 scatter oracle, and the largest
    difference between two runs of each (atomics sum in run-dependent
    order)."""
    assembly = assembly or mxu_gridder.default_assembly()
    p = plan(work, ts)
    g1 = grid_f32(work, p, assembly, ts)
    g2 = grid_f32(work, p, assembly, ts)
    with jax.enable_x64(True):
        o1 = grid_f64(work)
        o2 = grid_f64(work)
        err = float(_max_rel(g1, o1))
        rep32 = float(_max_rel(g2, g1.astype(jnp.complex128)))
        rep64 = float(_max_rel(o2, o1))
    name = f"grid[{assembly}] N={work.pixels} P={work.num_pols}"
    return (Check(name, err, GRID_TOL, extra={"n_vis": len(work.uv)}),
            Check(name + " run-to-run", rep32, GRID_TOL,
                  precision="float32 run 2 vs run 1",
                  extra={"scatter_f64_run_to_run": rep64}))


def check_degrid(work: Workload, assembly: str | None = None,
                 ts: int = 64, seed: int = 1) -> Check:
    """Degridded visibilities of a random model grid against the float64
    scatter degridder."""
    assembly = assembly or mxu_gridder.default_assembly()
    P, N = work.num_pols, work.pixels
    p = plan(work, ts)
    key = jax.random.PRNGKey(seed)
    kr, ki = jax.random.split(key)
    grid = jax.lax.complex(jax.random.normal(kr, (P, N, N), jnp.float32),
                           jax.random.normal(ki, (P, N, N), jnp.float32))
    ext = mxu_gridder.dense_pad_size(N, ts)
    gpad = jnp.pad(grid, ((0, 0), (0, ext - N), (0, ext - N)))
    zeros = jnp.zeros(p.vis.shape, jnp.complex64)
    valid = jnp.asarray(p.valid)
    out = mxu_gridder.degrid_chunks(
        gpad, jnp.asarray(work.kernel), jnp.asarray(p.uv),
        jnp.asarray(p.sub_uv), jnp.asarray(p.w_plane),
        jnp.ones(p.vis.shape, jnp.float32), zeros, jnp.asarray(p.anchor),
        valid, mxu_gridder.occupied_chunks(valid), pixels=N, rv=ts, ru=ts,
        assembly=assembly)
    pred32 = -out[jnp.asarray(p.row_chunk), jnp.asarray(p.row_slot)]
    with jax.enable_x64(True):
        n = len(work.uv)
        ref = -gridder.degrid_vis(
            grid.astype(jnp.complex128),
            jnp.asarray(work.kernel, jnp.complex128), jnp.asarray(work.uv),
            jnp.asarray(work.sub_uv), jnp.asarray(work.w_plane),
            jnp.ones((n, P), jnp.float64), jnp.zeros((n, P), jnp.complex128),
            pixels=N)
        err = float(_max_rel(pred32, ref))
    return Check(f"degrid[{assembly}] N={N} P={P}", err, DEGRID_TOL,
                 extra={"n_vis": n})


def _lm_n(pixels: int, pixel_size: float) -> np.ndarray:
    lm = np.arange(pixels) * pixel_size - 0.5 * pixels * pixel_size
    return np.sqrt(1 - (lm[:, None] ** 2 + lm[None, :] ** 2))


def image_to_grid_reference(image, taper1d, w, pixel_size):
    """Numpy float64 forward transform (mirror of
    :func:`.ops.fourier.grid_to_image_reference`): divide by taper^2 and
    n, apply the conjugate W phase, then a centred FFT."""
    n = _lm_n(image.shape[-1], pixel_size)
    layer = (np.asarray(image, np.float64) / (np.outer(taper1d, taper1d) * n)
             * np.exp(-2j * np.pi * w * (n - 1)))
    return np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(layer, axes=(-2, -1)),
                                       axes=(-2, -1)), axes=(-2, -1))


def check_fft(work: Workload, w: float = 3000.0,
              n_components: int = 256, seed: int = 2) -> tuple[Check, ...]:
    """Grid->image of a gridded workload, and image->grid of a model
    image, against numpy's float64 FFT of the same input."""
    N, P = work.pixels, work.num_pols
    fgp = work.grid_p.fixed
    taper = wkernel.taper(N, fgp.antialias_width, fgp.oversample)
    ps = work.image_p.pixel_size
    grid = grid_f32(work, plan(work), mxu_gridder.default_assembly())
    image = fourier.grid_to_image(
        grid, jnp.zeros((P, N, N), jnp.float32),
        jnp.asarray(taper, jnp.float32), jnp.float32(w), jnp.float32(ps),
        pixels=N)
    grid_np = np.asarray(grid).astype(np.complex128)
    ref = fourier.grid_to_image_reference(
        grid_np, np.zeros((P, N, N)), taper, w, ps)
    del grid_np
    diff = np.abs(np.asarray(image, np.float64) - ref)
    peak = np.abs(ref).max()
    t2 = np.outer(taper, taper)
    field = t2 / t2.max() >= 0.002
    q = N // 4
    field_err = float(diff[:, field].max() / peak)
    centre_err = float(diff[:, q:-q, q:-q].max() / peak)
    del diff, ref

    rng = np.random.default_rng(seed)
    model = np.zeros((P, N, N), np.float32)
    ys = rng.integers(q, N - q, n_components)
    xs = rng.integers(q, N - q, n_components)
    model[:, ys, xs] = rng.uniform(0.01, 1.0, (P, n_components))
    g32 = fourier.image_to_grid(
        jnp.asarray(model), jnp.asarray(taper, jnp.float32), jnp.float32(w),
        jnp.float32(ps), pixels=N)
    gref = image_to_grid_reference(model, taper, w, ps)
    g_err = float(np.abs(np.asarray(g32) - gref).max() / np.abs(gref).max())
    name = f"N={N} P={P}"
    return (Check(f"grid->image {name} (taper^2>=0.002)", field_err,
                  IMAGE_TOL_FIELD),
            Check(f"grid->image {name} (central half)", centre_err,
                  IMAGE_TOL_CENTRE),
            Check(f"image->grid {name}", g_err, GRID_FROM_IMAGE_TOL,
                  extra={"components": n_components}))


def check_predict(n_vis: int = 1 << 20, n_sources: int = 256,
                  pixels: int = 4096, num_pols: int = 1,
                  seed: int = 3) -> Check:
    """Direct-DFT prediction (``ops/predict.py``) against a float64 DFT of
    the same components at the same quantized coordinates."""
    work = make_workload(pixels, num_pols, n_vis, seed=seed)
    rng = np.random.default_rng(seed)
    ip, gp = work.image_p, work.grid_p
    half = ip.pixels // 2 * ip.pixel_size
    l = rng.uniform(-half / 2, half / 2, n_sources)
    m = rng.uniform(-half / 2, half / 2, n_sources)
    lmn = np.stack([l, m, np.sqrt(1 - l * l - m * m) - 1], -1)
    flux = rng.uniform(0.01, 1.0, (n_sources, num_pols))
    uv_scale, w_scale, w_bias = predict.uvw_scale_bias(ip, gp)
    O = gp.fixed.oversample
    zeros = jnp.zeros(work.vis.shape, jnp.complex64)
    out = predict.predict_subtract(
        jnp.asarray(lmn, jnp.float32), jnp.asarray(flux, jnp.float32),
        jnp.asarray(work.uv), jnp.asarray(work.sub_uv),
        jnp.asarray(work.w_plane), zeros,
        jnp.ones(work.vis.shape, jnp.float32), jnp.float32(uv_scale),
        jnp.float32(w_scale), jnp.float32(w_bias), oversample=O)
    uvw = np.stack([(work.uv[:, 0] * O + work.sub_uv[:, 0] + 0.5) * uv_scale,
                    (work.uv[:, 1] * O + work.sub_uv[:, 1] + 0.5) * uv_scale,
                    work.w_plane * w_scale + w_bias], -1)
    lmn32 = lmn.astype(np.float32).astype(np.float64)
    with jax.enable_x64(True):
        turns = jnp.matmul(jnp.asarray(uvw), jnp.asarray(lmn32).T,
                           precision="highest")
        ref = jnp.matmul(jnp.exp(-2j * jnp.pi * turns), jnp.asarray(
            flux.astype(np.float32).astype(np.float64)),
            precision="highest")
        err = float(jnp.max(jnp.abs(-out.astype(jnp.complex128) - ref)))
        max_turns = float(jnp.max(jnp.abs(turns)))
    scale = float(np.abs(flux).sum(axis=0).max())
    tol = 2 * np.pi * max_turns * 8 * np.finfo(np.float32).eps
    return Check(f"predict n_vis={n_vis} sources={n_sources}",
                 err / scale, tol, extra={"max_phase_turns": max_turns})
