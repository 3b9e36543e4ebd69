"""Spectral-cube imaging: the FULL per-channel pipeline as one sharded
device function, processed in waves of channels across the mesh.

Where :mod:`.multichannel` provides the benchmarkable dirty+CLEAN step,
this module runs the complete Cotton-Schwab loop on device per channel —
weights, PSF, major cycles with degridding model subtraction, noise-derived
thresholds — with exactly two host round-trips per wave:

1. ``wave_image`` (sharded jit): everything through the last minor cycle;
   returns residual, model and the PSF core per channel;
2. host: restoring-beam fits (scipy, per channel, on the small PSF cores);
3. ``wave_restore`` (sharded jit): Gaussian restore + residual add.

Memory strategy: a wave holds ``C = mesh chan-size`` channels; each device
owns one channel's images at a time, so arbitrarily long cubes stream
through bounded HBM.  Per-channel physics are traced inputs (one
compilation serves all waves).

The CLEAN threshold logic mirrors the reference frontend (frontend.py:
545-583): threshold = max(noise * sigma-scale, (1 - major_gain) * peak),
with the noise estimated on device per major cycle.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P  # noqa: N817

from ..ops import clean as clean_ops
from ..ops import mxu_gridder
from ..ops.fourier import (grid_to_image_batched_impl, grid_to_image_impl,
                           grid_to_image_parts_impl, image_to_grid_impl,
                           image_to_grid_parts_impl)
from .slices import scan_slices


@dataclasses.dataclass(frozen=True)
class CubeConfig:
    """Static configuration for cube-mode imaging."""

    pixels: int
    num_pols: int
    kernel_width: int
    oversample: int
    w_planes: int
    w_slices: int
    chunks_per_slice: int
    chunk_size: int
    rv: int = 64
    ru: int = 64
    # CLEAN
    majors: int = 2
    minor: int = 512
    patch: int = 65
    psf_core: int = 64
    border_pixels: int = 0
    loop_gain: float = 0.1
    major_gain: float = 0.85
    threshold_sigma: float = 5.0
    clean_mode: int = clean_ops.CLEAN_I
    #: "natural", "uniform" or "robust"
    weight_type: str = "natural"
    robustness: float = 0.0
    #: static sky-model capacity for on-device continuum subtraction
    #: (``--subtract``); 0 disables the subtraction stage entirely
    num_sources: int = 0
    #: apply primary-beam correction in the restore stage
    primary_beam: bool = False
    primary_beam_cutoff: float = 0.1

    @property
    def clean_cfg(self) -> clean_ops.CleanConfig:
        return clean_ops.CleanConfig(
            pixels=self.pixels, num_pols=self.num_pols,
            border_pixels=self.border_pixels, patch_y=self.patch,
            patch_x=self.patch, mode=self.clean_mode,
            loop_gain=self.loop_gain)


class SkyBatch(NamedTuple):
    """Per-wave continuum-subtraction model (zero-padded to
    ``cfg.num_sources``; zero-flux rows are no-ops)."""

    lmn: jnp.ndarray         # (C, Smax, 3) float32 (l, m, n-1)
    flux: jnp.ndarray        # (C, Smax, P) float32, sinc-tapered
    uvw_scales: jnp.ndarray  # (C, 3) float32 (uv_scale, w_scale, w_bias)


class WaveResult(NamedTuple):
    residual: jnp.ndarray   # (C, P, N, N)
    model: jnp.ndarray      # (C, P, N, N)
    psf_core: jnp.ndarray   # (C, P, core, core)
    noise: jnp.ndarray      # (C,)
    psf_peak: jnp.ndarray   # (C, P)
    minor: jnp.ndarray      # (C,) int32 total minor cycles over majors
    weights_noise: jnp.ndarray      # (C,) thermal RMS from weights (<0: n/a)
    normalized_noise: jnp.ndarray   # (C,) RMS relative to natural


def _nc_slices_of(valid) -> jnp.ndarray:
    """Occupied-chunk count per w-slice from a (S, NC, Mc) valid mask."""
    return jnp.sum(jnp.any(valid, axis=-1).astype(jnp.int32), axis=-1)


def _grid_slices(cfg: CubeConfig, kernel, density, uv, sub_uv, w_plane,
                 anchor, valid, vis, taper1d, pixel_size, mid_w, psum,
                 nc_slices=None):
    """W-stacked dirty image from chunked visibilities (device).

    ``nc_slices`` (S,) bounds the gridder's group loop to occupied chunks;
    it must be unbatched across a channel vmap (max over channels) so the
    dynamic loop bound does not trigger masked batching of the big tile
    carry."""
    N = cfg.pixels
    Pp = cfg.num_pols
    if nc_slices is None:
        nc_slices = _nc_slices_of(valid)
    if cfg.weight_type == "natural":
        density = None   # density == 1: skip the per-vis window lookups

    def one_grid(uv_s, sub_s, wp_s, anc_s, val_s, vis_s, nc_s):
        ext = mxu_gridder.dense_pad_size(N, cfg.rv)
        gpad = jnp.zeros((Pp, ext, ext), jnp.complex64)
        gpad = mxu_gridder.grid_chunks_dense_impl(
            gpad, kernel, density, uv_s, sub_s, wp_s, vis_s, anc_s, val_s,
            None, nc_s,
            pixels=N, ts=cfg.rv, assembly=mxu_gridder.default_assembly())
        return psum(gpad[:, :N, :N])

    def one_grid_parts(uv_s, sub_s, wp_s, anc_s, val_s, vis_s, nc_s):
        # f32 re/im planes from the gridder into the FFT: measured 2%
        # faster than the complex grid per slice on an H100
        # (benchmarks/gpu_defaults.py).
        gr, gi = mxu_gridder.grid_chunks_parts_impl(
            kernel, density, uv_s, sub_s, wp_s, vis_s, anc_s, val_s,
            None, nc_s,
            pixels=N, ts=cfg.rv, assembly=mxu_gridder.default_assembly())
        return psum(gr), psum(gi)

    # The parts planes are float32; --precision double keeps the complex
    # path.
    use_parts = taper1d.dtype == jnp.float32

    # Completely empty w-slices skip the whole slice body (tile init, grid
    # psum, FFT, W-correction): a zero grid contributes exactly zero to
    # the dirty accumulation, so the skip is bitwise-neutral.  nc_slices
    # is pmaxed over the vis shards by the shard_fns, so the cond (and
    # the psum inside its taken branch) is uniform across the mesh.
    dirty0 = jnp.zeros((Pp, N, N), taper1d.dtype)
    if os.environ.get("KTPU_BATCH_SLICES", "0") == "1":
        # one batched FFT+correction over all W slices (see multichannel)
        def slice_grid(_, xs):
            uv_s, sub_s, wp_s, anc_s, val_s, vis_s, nc_s = xs
            grid = jax.lax.cond(
                nc_s > 0,
                lambda: one_grid(uv_s, sub_s, wp_s, anc_s, val_s, vis_s,
                                 nc_s),
                lambda: jnp.zeros((Pp, N, N), jnp.complex64))
            return 0, grid

        _, grids = jax.lax.scan(
            slice_grid, 0,
            (uv, sub_uv, w_plane, anchor, valid, vis, nc_slices))
        return grid_to_image_batched_impl(grids, dirty0, taper1d, mid_w,
                                          pixel_size, pixels=N)

    def body(dirty, xs):
        uv_s, sub_s, wp_s, anc_s, val_s, vis_s, w_mid, nc_s = xs

        def do(dirty):
            if use_parts:
                gr, gi = one_grid_parts(uv_s, sub_s, wp_s, anc_s, val_s,
                                        vis_s, nc_s)
                return grid_to_image_parts_impl(gr, gi, dirty, taper1d,
                                                w_mid, pixel_size,
                                                pixels=N)
            grid = one_grid(uv_s, sub_s, wp_s, anc_s, val_s, vis_s, nc_s)
            return grid_to_image_impl(grid, dirty, taper1d, w_mid,
                                      pixel_size, pixels=N)

        return jax.lax.cond(nc_s > 0, do, lambda d: d, dirty), None

    dirty, _ = scan_slices(body, dirty0,
                           (uv, sub_uv, w_plane, anchor, valid, vis, mid_w,
                            nc_slices))
    return dirty


def _degrid_slices(cfg: CubeConfig, kernel, model, uv, sub_uv, w_plane,
                   anchor, valid, weights, vis, taper1d, pixel_size, mid_w,
                   nc_slices=None):
    """Subtract the degridded model from every slice's visibilities."""
    N = cfg.pixels
    if nc_slices is None:
        nc_slices = _nc_slices_of(valid)

    use_parts = taper1d.dtype == jnp.float32

    def body(_, xs):
        uv_s, sub_s, wp_s, anc_s, val_s, wt_s, vis_s, w_mid, nc_s = xs

        def do():
            if use_parts:
                # f32 planes from the FFT into the degrid windows.
                gr, gi = image_to_grid_parts_impl(model, taper1d, w_mid,
                                                  pixel_size, pixels=N)
                pad = ((0, 0), (0, cfg.rv), (0, cfg.ru))
                gpad = (jnp.pad(gr, pad), jnp.pad(gi, pad))
            else:
                grid = image_to_grid_impl(model, taper1d, w_mid,
                                          pixel_size, pixels=N)
                gpad = jnp.pad(grid, ((0, 0), (0, cfg.rv), (0, cfg.ru)))
            return mxu_gridder.degrid_chunks_impl(
                gpad, kernel, uv_s, sub_s, wp_s, wt_s, vis_s, anc_s, val_s,
                nc_s,
                pixels=N, rv=cfg.rv, ru=cfg.ru,
                assembly=mxu_gridder.default_assembly())

        # An empty slice has nothing to degrid: skip its model FFT and
        # keep the stored (all-invalid) visibilities unchanged.
        new_vis = jax.lax.cond(nc_s > 0, do, lambda: vis_s)
        return None, new_vis

    _, new_vis = scan_slices(
        body, None,
        (uv, sub_uv, w_plane, anchor, valid, weights, vis, mid_w,
         nc_slices))
    return new_vis


def _predict_subtract_slices(cfg: CubeConfig, sky_lmn, sky_flux, uv, sub_uv,
                             w_plane, valid, weights, vis, uvw_scales,
                             mid_w, nc_slices=None):
    """On-device continuum subtraction: subtract the DFT of the sky model
    from every slice's stored (pre-weighted) visibilities (reference
    predict.py:419-439; per-channel equivalent ops/predict.py).

    Coordinates are dequantized at bin centres exactly as the per-channel
    predictor does, so the subtraction is consistent with the gridder.
    Completely empty w-slices skip the DFT (valid masking makes the
    subtraction a no-op there anyway)."""
    O = cfg.oversample  # noqa: E741
    uv_scale, w_scale, w_bias = (uvw_scales[0], uvw_scales[1],
                                 uvw_scales[2])
    hp = jax.lax.Precision.HIGHEST
    if nc_slices is None:
        nc_slices = _nc_slices_of(valid)

    def body(_, xs):
        uv_s, sub_s, wp_s, val_s, wt_s, vis_s, w_mid, nc_s = xs

        def do():
            u = (uv_s[..., 0].astype(jnp.float32) * O
                 + sub_s[..., 0].astype(jnp.float32) + 0.5) * uv_scale
            v = (uv_s[..., 1].astype(jnp.float32) * O
                 + sub_s[..., 1].astype(jnp.float32) + 0.5) * uv_scale
            w = wp_s.astype(jnp.float32) * w_scale + w_bias + w_mid
            uvw = jnp.stack([u, v, w], axis=-1).reshape(-1, 3)  # (NC*Mc, 3)
            phase = (-2 * jnp.pi) * jnp.matmul(uvw, sky_lmn.T, precision=hp)
            re = jnp.matmul(jnp.cos(phase), sky_flux, precision=hp)
            im = jnp.matmul(jnp.sin(phase), sky_flux, precision=hp)
            pred = (re + 1j * im).reshape(vis_s.shape)
            return vis_s - wt_s * pred * val_s[..., None]

        return None, jax.lax.cond(nc_s > 0, do, lambda: vis_s)

    _, new_vis = scan_slices(
        body, None,
        (uv, sub_uv, w_plane, valid, weights, vis, mid_w, nc_slices))
    return new_vis


def _clean_stage(cfg: CubeConfig, residual, model, psf_patch_arr):
    """One major cycle's CLEAN: reset tiles, derive the threshold on
    device, run minor cycles.  Returns (residual, model, noise)."""
    ccfg = cfg.clean_cfg
    noise = clean_ops.noise_est(residual, border_pixels=cfg.border_pixels)
    pad = ccfg.pad
    res_pad = jnp.pad(residual, ((0, 0), (pad, pad), (pad, pad)))
    T = ccfg.tiles
    state = clean_ops.CleanState(
        res_pad, model, jnp.zeros((T, T), residual.dtype),
        jnp.zeros((T, T, 2), jnp.int32))
    state = clean_ops.reset(ccfg, state)

    # First cycle measures the starting peak (threshold 0 always fires).
    state, _k, first_peak, _last = clean_ops.minor_cycles_impl(
        ccfg, state, psf_patch_arr, jnp.zeros((), residual.dtype), 1)
    nts = clean_ops.noise_threshold_scale(cfg.clean_mode,
                                          cfg.threshold_sigma, cfg.num_pols)
    if cfg.clean_mode == clean_ops.CLEAN_SUMSQ:
        peak_power = jnp.sqrt(first_peak)
    else:
        peak_power = first_peak
    threshold_power = jnp.maximum(noise * nts,
                                  (1.0 - cfg.major_gain) * peak_power)
    if cfg.clean_mode == clean_ops.CLEAN_SUMSQ:
        threshold = threshold_power * threshold_power
    else:
        threshold = threshold_power
    state, _k2, _f2, _l2 = clean_ops.minor_cycles_impl(
        ccfg, state, psf_patch_arr, threshold, cfg.minor - 1)
    cycles = (_k + _k2).astype(jnp.int32)
    return clean_ops.residual_image(ccfg, state), state.model, noise, cycles


def _channel_density_psf(cfg: CubeConfig, kernel, taper1d, pixel_size,
                         mid_w, uv, sub_uv, w_plane, anchor, valid,
                         weights, psum, nc_slices=None):
    """Imaging weights + normalized PSF for one channel (device)."""
    N = cfg.pixels
    Pp = cfg.num_pols
    half = N // 2

    # ---- imaging weights (natural / uniform / robust; Briggs formulas,
    # fully on device including the robust mean-weight pass)
    if cfg.weight_type in ("uniform", "robust"):
        flat_uv = uv.reshape(-1, 2)
        flat_w = (weights * valid[..., None]).reshape(-1, Pp)
        wgrid = jnp.zeros((Pp, N, N), jnp.float32)
        wgrid = wgrid.at[:, flat_uv[:, 1] + half, flat_uv[:, 0] + half].add(
            flat_w.T, mode="drop")
        wgrid = psum(wgrid)
        if cfg.weight_type == "robust":
            w0 = wgrid[0]
            mean_w = jnp.sum(w0 * w0) / jnp.sum(w0)
            s2 = (5.0 * 10.0 ** (-cfg.robustness)) ** 2 / mean_w
            density = jnp.where(
                wgrid > 0,
                1.0 / (jnp.where(wgrid > 0, wgrid, 1.0) * s2 + 1.0), 0.0)
        else:
            density = jnp.where(wgrid > 0,
                                1.0 / jnp.where(wgrid > 0, wgrid, 1.0), 0.0)
        # Thermal-noise statistics from the weights (same formulas as
        # ops.weights.density_weights / the per-channel finalize path).
        w0 = wgrid[0]
        d0 = density[0]
        sum_w = jnp.sum(w0)
        sum_dw = jnp.sum(d0 * w0)
        sum_d2w = jnp.sum(d0 * d0 * w0)
        w_rms = jnp.sqrt(sum_d2w) / jnp.maximum(sum_dw, 1e-30)
        w_norm = w_rms * jnp.sqrt(sum_w)
    else:
        density = jnp.ones((Pp, N, N), jnp.float32)
        # natural weighting reports no weights-derived RMS (sentinel < 0)
        w_rms = jnp.float32(-1.0)
        w_norm = jnp.float32(1.0)

    # ---- PSF: grid the weights as "visibilities"
    psf = _grid_slices(cfg, kernel, density, uv, sub_uv, w_plane, anchor,
                       valid, weights.astype(jnp.complex64)
                       * valid[..., None], taper1d, pixel_size, mid_w, psum,
                       nc_slices=nc_slices)
    psf_peak = psf[:, half, half]
    scale = jnp.where(psf_peak != 0,
                      1.0 / jnp.where(psf_peak != 0, psf_peak, 1.0), 0.0)
    psf = psf * scale[:, None, None]
    return density, psf, psf_peak, scale, w_rms, w_norm


def _channel_majors(cfg: CubeConfig, kernel, taper1d, pixel_size, mid_w,
                    uv, sub_uv, w_plane, anchor, valid, weights, vis,
                    density, scale, patch, psum, sky_lmn=None,
                    sky_flux=None, uvw_scales=None, nc_slices=None):
    """Major cycles for one channel given density weights and a PSF patch."""
    N = cfg.pixels
    Pp = cfg.num_pols
    grid_fn = partial(_grid_slices, cfg, kernel, density, uv, sub_uv,
                      w_plane, anchor, valid)

    # ---- continuum subtraction (once, up front: the major loop always
    # degrids against the original ``vis``, so one subtraction here is
    # equivalent to the reference's per-pass re-subtraction)
    if sky_lmn is not None:
        vis = _predict_subtract_slices(cfg, sky_lmn, sky_flux, uv, sub_uv,
                                       w_plane, valid, weights, vis,
                                       uvw_scales, mid_w,
                                       nc_slices=nc_slices)

    # ---- major cycles
    model = jnp.zeros((Pp, N, N), taper1d.dtype)
    noise = jnp.zeros((), taper1d.dtype)
    cur_vis = vis
    residual = jnp.zeros((Pp, N, N), taper1d.dtype)
    minor_total = jnp.zeros((), jnp.int32)
    for major in range(cfg.majors):
        if major > 0:
            cur_vis = _degrid_slices(cfg, kernel, model, uv, sub_uv,
                                     w_plane, anchor, valid, weights, vis,
                                     taper1d, pixel_size, mid_w,
                                     nc_slices=nc_slices)
        dirty = grid_fn(cur_vis, taper1d, pixel_size, mid_w, psum,
                        nc_slices=nc_slices)
        dirty = dirty * scale[:, None, None]
        residual, model, noise, cycles = _clean_stage(cfg, dirty, model,
                                                      patch)
        minor_total = minor_total + cycles
    return residual, model, noise, minor_total


def _channel_cube_pipeline(cfg: CubeConfig, kernel, taper1d, pixel_size,
                           mid_w, uv, sub_uv, w_plane, anchor, valid,
                           weights, vis, vis_axis, sky_lmn=None,
                           sky_flux=None, uvw_scales=None, nc_slices=None):
    N = cfg.pixels
    Pp = cfg.num_pols
    psum = (lambda x: x) if vis_axis is None else partial(jax.lax.psum,
                                                          axis_name=vis_axis)
    half = N // 2

    density, psf, psf_peak, scale, w_rms, w_norm = _channel_density_psf(
        cfg, kernel, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane,
        anchor, valid, weights, psum, nc_slices=nc_slices)
    patch = jax.lax.dynamic_slice(
        psf, (0, half - cfg.patch // 2, half - cfg.patch // 2),
        (Pp, cfg.patch, cfg.patch))
    core = jax.lax.dynamic_slice(
        psf, (0, half - cfg.psf_core // 2, half - cfg.psf_core // 2),
        (Pp, cfg.psf_core, cfg.psf_core))

    residual, model, noise, minor_total = _channel_majors(
        cfg, kernel, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane,
        anchor, valid, weights, vis, density, scale, patch, psum,
        sky_lmn=sky_lmn, sky_flux=sky_flux, uvw_scales=uvw_scales,
        nc_slices=nc_slices)
    return (residual, model, core, noise, psf_peak, minor_total, w_rms,
            w_norm)


def make_wave_image(mesh: Mesh, cfg: CubeConfig):
    """Sharded jitted wave function: batch of C channels -> WaveResult.

    When ``cfg.num_sources > 0`` the returned callable takes a second
    :class:`SkyBatch` argument for on-device continuum subtraction."""
    shard_map = jax.shard_map
    subtract = cfg.num_sources > 0

    def shard_fn(kernel, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane,
                 anchor, valid, weights, vis, *sky):
        # max over channels (unbatched loop bound), pmax over vis shards
        # (uniform empty-slice cond; see _grid_slices).
        nc_slices = jax.lax.pmax(
            jnp.max(jax.vmap(_nc_slices_of)(valid), axis=0), "vis")

        def one(args, nc_s):
            if subtract:
                core, (s_lmn, s_flux, s_scales) = args[:-3], args[-3:]
                return _channel_cube_pipeline(
                    cfg, *core, vis_axis="vis", sky_lmn=s_lmn,
                    sky_flux=s_flux, uvw_scales=s_scales, nc_slices=nc_s)
            return _channel_cube_pipeline(cfg, *args, vis_axis="vis",
                                          nc_slices=nc_s)

        return jax.vmap(one, in_axes=(0, None))(
            (kernel, taper1d, pixel_size, mid_w, uv,
             sub_uv, w_plane, anchor, valid, weights, vis) + sky,
            nc_slices)

    chan = P("chan")
    c5 = P("chan", None, "vis", None, None)
    c4 = P("chan", None, "vis", None)
    in_specs = (chan, chan, chan, chan, c5, c5, c4, c4, c4, c5, c5)
    if subtract:
        in_specs = in_specs + (chan, chan, chan)
    out_specs = (chan,) * 8
    fn = shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    jitted = jax.jit(fn)

    def wave(batch, sky: SkyBatch = None) -> WaveResult:
        args = (batch.kernel, batch.taper1d, batch.pixel_size, batch.mid_w,
                batch.uv, batch.sub_uv, batch.w_plane, batch.anchor,
                batch.valid, batch.weights, batch.vis)
        if subtract:
            if sky is None:
                raise ValueError("cfg.num_sources > 0 requires a SkyBatch")
            args = args + (sky.lmn, sky.flux, sky.uvw_scales)
        return WaveResult(*jitted(*args))

    return wave


class PsfWaveResult(NamedTuple):
    density: jnp.ndarray   # (C, P, N, N) imaging-weight density
    psf: jnp.ndarray       # (C, P, N, N), peak-normalized
    psf_peak: jnp.ndarray  # (C, P)
    scale: jnp.ndarray     # (C, P)
    weights_noise: jnp.ndarray     # (C,) thermal RMS from weights (<0: n/a)
    normalized_noise: jnp.ndarray  # (C,)


def make_wave_psf(mesh: Mesh, cfg: CubeConfig):
    """Phase-A wave: density weights + full normalized PSF per channel.

    With :func:`make_wave_clean` this forms the auto-patch cube pipeline:
    the host inspects the PSFs, picks the CLEAN patch size for the wave
    (reference clean.py:894-936 semantics via ops.clean.psf_patch), and
    runs phase B compiled for that patch."""
    def shard_fn(kernel, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane,
                 anchor, valid, weights):
        psum = partial(jax.lax.psum, axis_name="vis")
        nc_slices = jax.lax.pmax(
            jnp.max(jax.vmap(_nc_slices_of)(valid), axis=0), "vis")

        def one(args, nc_s):
            return _channel_density_psf(cfg, *args, psum, nc_slices=nc_s)

        return jax.vmap(one, in_axes=(0, None))(
            (kernel, taper1d, pixel_size, mid_w, uv,
             sub_uv, w_plane, anchor, valid, weights), nc_slices)

    chan = P("chan")
    c5 = P("chan", None, "vis", None, None)
    c4 = P("chan", None, "vis", None)
    in_specs = (chan, chan, chan, chan, c5, c5, c4, c4, c4, c5)
    out_specs = (chan,) * 6
    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    jitted = jax.jit(fn)

    def wave(batch) -> PsfWaveResult:
        return PsfWaveResult(*jitted(
            batch.kernel, batch.taper1d, batch.pixel_size, batch.mid_w,
            batch.uv, batch.sub_uv, batch.w_plane, batch.anchor,
            batch.valid, batch.weights))

    return wave


def make_wave_clean(mesh: Mesh, cfg: CubeConfig, patch: int):
    """Phase-B wave: major cycles with a wave-specific CLEAN patch size.

    Takes the phase-A outputs (density, psf, scale) as inputs; the patch
    is sliced from the PSF on device at the static ``patch`` size.
    Returns (residual, model, noise, minor)."""
    cfgp = dataclasses.replace(cfg, patch=patch)
    subtract = cfg.num_sources > 0
    half = cfg.pixels // 2

    def shard_fn(kernel, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane,
                 anchor, valid, weights, vis, density, psf, scale, *sky):
        psum = partial(jax.lax.psum, axis_name="vis")

        nc_slices = jax.lax.pmax(
            jnp.max(jax.vmap(_nc_slices_of)(valid), axis=0), "vis")

        def one(args, nc_s):
            if subtract:
                core, (s_lmn, s_flux, s_scales) = args[:-3], args[-3:]
            else:
                core = args
                s_lmn = s_flux = s_scales = None
            (kern, tap, ps, midw, uv_c, sub_c, wp_c, anc_c, val_c, wt_c,
             vis_c, den_c, psf_c, sc_c) = core
            patch_arr = jax.lax.dynamic_slice(
                psf_c, (0, half - patch // 2, half - patch // 2),
                (cfg.num_pols, patch, patch))
            return _channel_majors(
                cfgp, kern, tap, ps, midw, uv_c, sub_c, wp_c, anc_c,
                val_c, wt_c, vis_c, den_c, sc_c, patch_arr, psum,
                sky_lmn=s_lmn, sky_flux=s_flux, uvw_scales=s_scales,
                nc_slices=nc_s)

        return jax.vmap(one, in_axes=(0, None))(
            (kernel, taper1d, pixel_size, mid_w, uv,
             sub_uv, w_plane, anchor, valid, weights,
             vis, density, psf, scale) + sky, nc_slices)

    chan = P("chan")
    c5 = P("chan", None, "vis", None, None)
    c4 = P("chan", None, "vis", None)
    in_specs = (chan, chan, chan, chan, c5, c5, c4, c4, c4, c5, c5,
                chan, chan, chan)
    if subtract:
        in_specs = in_specs + (chan, chan, chan)
    out_specs = (chan, chan, chan, chan)
    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    jitted = jax.jit(fn)

    def wave(batch, psf_result: PsfWaveResult, sky: SkyBatch = None):
        args = (batch.kernel, batch.taper1d, batch.pixel_size, batch.mid_w,
                batch.uv, batch.sub_uv, batch.w_plane, batch.anchor,
                batch.valid, batch.weights, batch.vis, psf_result.density,
                psf_result.psf, psf_result.scale)
        if subtract:
            if sky is None:
                raise ValueError("cfg.num_sources > 0 requires a SkyBatch")
            args = args + (sky.lmn, sky.flux, sky.uvw_scales)
        return jitted(*args)

    return wave


def make_wave_restore(mesh: Mesh, cfg: CubeConfig):
    """Sharded restore: convolve models with per-channel Gaussian beams and
    add residuals.  ``beam_m`` is (C, 2, 2): the covariance square root of
    each channel's fitted beam in pixels.

    With ``cfg.primary_beam`` the callable takes a fourth per-channel
    power-beam argument (C, N, N) and divides it out first — model filled
    with 0 and residual with NaN below the cutoff, matching the
    per-channel path (reference frontend.py:586-605)."""
    N = cfg.pixels
    apply_pb = cfg.primary_beam
    cutoff = cfg.primary_beam_cutoff

    def one(model, residual, beam_m, *pbeam):
        if apply_pb:
            (pb,) = pbeam
            ok = pb >= cutoff
            safe = jnp.where(ok, pb, 1.0)[None]
            model = jnp.where(ok[None], model / safe, 0.0)
            residual = jnp.where(ok[None], residual / safe, jnp.nan)
        model_ft = jnp.fft.fft2(model, axes=(-2, -1))
        freqs = jnp.fft.fftfreq(N).astype(model.dtype)
        coords = jnp.stack(jnp.meshgrid(freqs, freqs, indexing="ij"),
                           axis=-1)
        rot = jnp.einsum("yxj,ij->yxi", coords, beam_m, precision="highest")
        r2 = jnp.sum(rot ** 2, axis=-1)
        det = jnp.abs(beam_m[0, 0] * beam_m[1, 1]
                      - beam_m[0, 1] * beam_m[1, 0])
        beam_ft = (2 * jnp.pi) * det * jnp.exp(-2.0 * (jnp.pi ** 2) * r2)
        restored = jnp.fft.ifft2(model_ft * beam_ft[None], axes=(-2, -1)).real
        return restored.astype(model.dtype) + residual

    nin = 4 if apply_pb else 3
    fn = jax.shard_map(
        jax.vmap(one), mesh=mesh,
        in_specs=(P("chan"),) * nin,
        out_specs=P("chan"), check_vma=False)
    return jax.jit(fn)


def fit_wave_beams(psf_cores: np.ndarray) -> np.ndarray:
    """Fit restoring beams on the host for a wave; returns (C, 2, 2)
    covariance square roots plus the Beam list."""
    from ..ops import beam as beam_ops

    ms = []
    beams = []
    for core in psf_cores:
        b = beam_ops.fit_beam(core[0])
        beams.append(b)
        ms.append(b.covariance_sqrt())
    return np.stack(ms).astype(np.float32), beams
