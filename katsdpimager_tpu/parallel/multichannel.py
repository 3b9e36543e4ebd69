"""Channel- and visibility-sharded imaging step (matmul-chunk formulation).

The full per-channel pipeline — weight gridding, uniform density weights,
dense-matmul gridding per W slice (:mod:`..ops.mxu_gridder`), FFT +
W-correction accumulation, and batched CLEAN minor cycles — expressed as
ONE jitted function over stacked per-channel arrays, shard_mapped over a
``("chan", "vis")`` mesh:

- every ``[C, ...]`` input/output is sharded over ``chan`` (pure data
  parallelism; zero communication);
- the chunk axis ``NC`` (each chunk is a Morton-bucketed visibility block
  with a bounded grid window) is sharded over ``vis``: each shard grids its
  chunks locally and per-slice grids (and the weight grid) are reduced with
  ``lax.psum`` — the BASELINE's "visibility buckets + psum image reduction"
  configuration.

All shapes are static: channels in one batch share (pixels, kernel_width,
oversample, w_slices, chunks-per-slice, chunk capacity); per-channel physics
(wavelength-dependent pixel size, kernel tables, mid-w values) are traced
array inputs, so one compilation serves every channel batch.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import clean as clean_ops
from ..ops import mxu_gridder
from ..ops.fourier import (grid_to_image_batched_impl,
                           grid_to_image_impl, grid_to_image_parts_impl)
from .slices import scan_slices


@dataclasses.dataclass(frozen=True)
class MultiChannelConfig:
    """Static geometry shared by all channels of a batch."""

    pixels: int
    num_pols: int
    kernel_width: int
    oversample: int
    w_planes: int
    w_slices: int
    chunks_per_slice: int   # NC (padded)
    chunk_size: int         # Mc
    rv: int = 64
    ru: int = 64
    # CLEAN stage (0 minor cycles disables it)
    minor_cycles: int = 0
    patch: int = 33
    border_pixels: int = 0
    loop_gain: float = 0.1
    clean_mode: int = clean_ops.CLEAN_I
    #: imaging density weights: "natural" (no density grid, the CLI
    #: default) or "uniform"
    weight_type: str = "uniform"

    @property
    def clean_cfg(self) -> clean_ops.CleanConfig:
        return clean_ops.CleanConfig(
            pixels=self.pixels, num_pols=self.num_pols,
            border_pixels=self.border_pixels, patch_y=self.patch,
            patch_x=self.patch, mode=self.clean_mode,
            loop_gain=self.loop_gain)


class ChannelBatch(NamedTuple):
    """Stacked per-channel inputs.

    Leading axes: C channels, S w-slices, NC chunks, Mc vis per chunk.
    """

    kernel: jnp.ndarray       # (C, W, O, K) complex64
    taper1d: jnp.ndarray      # (C, N) real
    pixel_size: jnp.ndarray   # (C,) real
    mid_w: jnp.ndarray        # (C, S) real
    uv: jnp.ndarray           # (C, S, NC, Mc, 2) int32 (centred)
    sub_uv: jnp.ndarray       # (C, S, NC, Mc, 2) int32
    w_plane: jnp.ndarray      # (C, S, NC, Mc) int32
    anchor: jnp.ndarray       # (C, S, NC, 2) int32
    valid: jnp.ndarray        # (C, S, NC, Mc) bool
    weights: jnp.ndarray      # (C, S, NC, Mc, P) float32
    vis: jnp.ndarray          # (C, S, NC, Mc, P) complex64


def _channel_pipeline(cfg: MultiChannelConfig, kernel, taper1d, pixel_size,
                      mid_w, uv, sub_uv, w_plane, anchor, valid, weights,
                      vis, vis_axis, nc_slices=None):
    """One channel's full step on this shard's chunks.

    ``vis_axis`` is the mesh axis name for psum reductions (or None when
    running unsharded).  ``nc_slices`` (S,) int32 bounds the dense group
    loop per w-slice to occupied chunks; it MUST be unbatched across a
    channel vmap (callers take the max over channels) so the bound stays a
    plain while-loop predicate rather than a masked batched loop, and —
    when ``vis_axis`` is set — uniform across the vis shards (callers
    pmax it) so the empty-slice ``lax.cond`` below takes the same branch
    on every shard (its taken branch contains the grid psum).

    Completely empty w-slices (zero occupied chunks across all channels
    and shards — the outermost slices of real observations) skip the
    whole slice body: tile init, grid reduction, FFT and W-correction.
    A zero grid contributes exactly zero to the dirty accumulation, so
    the skip is bitwise-neutral.
    """
    N = cfg.pixels
    Pp = cfg.num_pols
    psum = (lambda x: x) if vis_axis is None else partial(jax.lax.psum,
                                                          axis_name=vis_axis)

    # ---- imaging weights: natural (density == 1, no grid) or uniform
    # (d = 1/W per occupied cell)
    half = N // 2
    if cfg.weight_type == "natural":
        density = None
    else:
        flat_uv = uv.reshape(-1, 2)
        flat_w = (weights * valid[..., None]).reshape(-1, Pp)
        wgrid = jnp.zeros((Pp, N, N), jnp.float32)
        wgrid = wgrid.at[:, flat_uv[:, 1] + half, flat_uv[:, 0] + half].add(
            flat_w.T, mode="drop")
        wgrid = psum(wgrid)
        density = jnp.where(
            wgrid > 0, 1.0 / jnp.where(wgrid > 0, wgrid, 1.0), 0.0)

    # ---- W-stacked dirty image via the matmul chunk gridder
    if nc_slices is None:
        nc_slices = jnp.sum(jnp.any(valid, axis=-1).astype(jnp.int32),
                            axis=-1)                     # (S,)

    batch_slices = os.environ.get("KTPU_BATCH_SLICES", "0") == "1"

    # The f32 parts planes (gridder -> FFT); double precision keeps the
    # complex path.
    use_parts = (taper1d.dtype == jnp.float32
                 and vis.dtype == jnp.complex64)

    def image_of(vis_like):
        def grid_slice(uv_s, sub_s, wp_s, anc_s, val_s, vis_s, nc_s):
            ext = mxu_gridder.dense_pad_size(N, cfg.rv)
            gpad = jnp.zeros((Pp, ext, ext), vis.dtype)
            gpad = mxu_gridder.grid_chunks_dense_impl(
                gpad, kernel, density, uv_s, sub_s, wp_s, vis_s, anc_s,
                val_s, None, nc_s,
                pixels=N, ts=cfg.rv,
                assembly=mxu_gridder.default_assembly())
            return psum(gpad[:, :N, :N])

        def grid_slice_parts(uv_s, sub_s, wp_s, anc_s, val_s, vis_s,
                             nc_s):
            gr, gi = mxu_gridder.grid_chunks_parts_impl(
                kernel, density, uv_s, sub_s, wp_s, vis_s, anc_s, val_s,
                None, nc_s, pixels=N, ts=cfg.rv,
                assembly=mxu_gridder.default_assembly())
            return psum(gr), psum(gi)

        dirty0 = jnp.zeros((Pp, N, N), taper1d.dtype)
        if batch_slices:
            # KTPU_BATCH_SLICES=1: stack per-slice grids, transform all
            # slices in ONE batched FFT + correction pass (S extra grids
            # of HBM; kills the per-slice fixed cost when S > 1).
            def slice_grid(_, xs):
                uv_s, sub_s, wp_s, anc_s, val_s, vis_s, nc_s = xs
                grid = jax.lax.cond(
                    nc_s > 0,
                    lambda: grid_slice(uv_s, sub_s, wp_s, anc_s, val_s,
                                       vis_s, nc_s),
                    lambda: jnp.zeros((Pp, N, N), vis.dtype))
                return 0, grid

            _, grids = jax.lax.scan(
                slice_grid, 0,
                (uv, sub_uv, w_plane, anchor, valid, vis_like, nc_slices))
            return grid_to_image_batched_impl(
                grids, dirty0, taper1d, mid_w, pixel_size, pixels=N)

        def slice_body(dirty, xs):
            uv_s, sub_s, wp_s, anc_s, val_s, vis_s, w_mid, nc_s = xs

            def do(dirty):
                if use_parts:
                    gr, gi = grid_slice_parts(uv_s, sub_s, wp_s, anc_s,
                                              val_s, vis_s, nc_s)
                    return grid_to_image_parts_impl(
                        gr, gi, dirty, taper1d, w_mid, pixel_size,
                        pixels=N)
                grid = grid_slice(uv_s, sub_s, wp_s, anc_s, val_s, vis_s,
                                  nc_s)
                return grid_to_image_impl(grid, dirty, taper1d, w_mid,
                                          pixel_size, pixels=N)

            dirty = jax.lax.cond(nc_s > 0, do, lambda d: d, dirty)
            return dirty, None

        dirty, _ = scan_slices(
            slice_body, dirty0,
            (uv, sub_uv, w_plane, anchor, valid, vis_like, mid_w,
             nc_slices))
        return dirty

    dirty = image_of(vis)

    if cfg.minor_cycles == 0:
        return dirty, jnp.zeros_like(dirty)

    # ---- CLEAN minor cycles (channel-local: no cross-shard work)
    # Real PSF: grid the weights as unit visibilities (same path as the
    # cube wave's _channel_density_psf; the dirty image is normalized by
    # the PSF peak so fluxes are in Jy/beam).
    ccfg = cfg.clean_cfg
    psf = image_of(weights.astype(vis.dtype) * valid[..., None])
    pk = psf[:, N // 2, N // 2]
    scale = jnp.where(pk != 0, 1.0 / jnp.where(pk != 0, pk, 1.0), 0.0)
    dirty = dirty * scale[:, None, None]
    patch = jax.lax.dynamic_slice(
        psf * scale[:, None, None],
        (0, N // 2 - cfg.patch // 2, N // 2 - cfg.patch // 2),
        (Pp, cfg.patch, cfg.patch))
    pad = ccfg.pad
    res_pad = jnp.pad(dirty, ((0, 0), (pad, pad), (pad, pad)))
    T = ccfg.tiles
    state = clean_ops.CleanState(
        res_pad, jnp.zeros_like(dirty),
        jnp.zeros((T, T), dirty.dtype), jnp.zeros((T, T, 2), jnp.int32))
    state = clean_ops.reset(ccfg, state)
    state, _k, _first, _last = clean_ops.minor_cycles_impl(
        ccfg, state, patch, jnp.zeros((), dirty.dtype), cfg.minor_cycles)
    residual = clean_ops.residual_image(ccfg, state)
    return residual, state.model


def make_imaging_step(mesh: Mesh, cfg: MultiChannelConfig):
    """Build the jitted, sharded multi-channel imaging step.

    Returns ``step(batch: ChannelBatch) -> (residual, model)`` with all
    ``[C, ...]`` arrays sharded over the ``chan`` mesh axis and the chunk
    axis sharded over ``vis``.
    """
    shard_map = jax.shard_map

    def shard_fn(kernel, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane,
                 anchor, valid, weights, vis):
        # Occupied-chunk bound per w-slice, maxed over this shard's
        # channels so the dense group loop's trip count is unbatched
        # (see _channel_pipeline docstring), and pmaxed over the vis
        # shards so the empty-slice cond's predicate (and its enclosed
        # psum) is uniform across the mesh.
        nc_slices = jax.lax.pmax(
            jnp.max(
                jnp.sum(jnp.any(valid, axis=-1).astype(jnp.int32), axis=-1),
                axis=0),
            "vis")                                        # (S,)

        def one(args, nc_s):
            return _channel_pipeline(cfg, *args, vis_axis="vis",
                                     nc_slices=nc_s)

        return jax.vmap(one, in_axes=(0, None))(
            (kernel, taper1d, pixel_size, mid_w, uv,
             sub_uv, w_plane, anchor, valid, weights, vis), nc_slices)

    chan = P("chan")
    # (C, S, NC, ...) with NC sharded over "vis"
    c5 = P("chan", None, "vis", None, None)
    c4 = P("chan", None, "vis", None)
    c3 = P("chan", None, "vis")
    in_specs = (chan, chan, chan, chan, c5, c5, c4, c4, c4, c5, c5)
    out_specs = (chan, chan)

    fn = shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                   out_specs=out_specs, check_vma=False)
    jitted = jax.jit(fn)

    def step(batch: ChannelBatch):
        return jitted(batch.kernel, batch.taper1d, batch.pixel_size,
                      batch.mid_w, batch.uv, batch.sub_uv, batch.w_plane,
                      batch.anchor, batch.valid, batch.weights, batch.vis)

    return step


def single_channel_step(cfg: MultiChannelConfig):
    """Unsharded single-channel forward (for compile checks / benchmarks).

    Returns a jittable ``fn(kernel, taper1d, pixel_size, mid_w, uv, sub_uv,
    w_plane, anchor, valid, weights, vis) -> (residual, model)``.
    """

    def fn(kernel, taper1d, pixel_size, mid_w, uv, sub_uv, w_plane, anchor,
           valid, weights, vis):
        return _channel_pipeline(cfg, kernel, taper1d, pixel_size, mid_w,
                                 uv, sub_uv, w_plane, anchor, valid,
                                 weights, vis, vis_axis=None)

    return fn


#: PartitionSpecs of the ChannelBatch fields, matching make_imaging_step's
#: in_specs (channel axis over "chan"; the chunk axis NC over "vis").
BATCH_SPECS = ChannelBatch(
    kernel=P("chan"), taper1d=P("chan"), pixel_size=P("chan"),
    mid_w=P("chan"),
    uv=P("chan", None, "vis", None, None),
    sub_uv=P("chan", None, "vis", None, None),
    w_plane=P("chan", None, "vis", None),
    anchor=P("chan", None, "vis", None),
    valid=P("chan", None, "vis", None),
    weights=P("chan", None, "vis", None, None),
    vis=P("chan", None, "vis", None, None))


def make_global_batch(mesh: Mesh, local: ChannelBatch) -> ChannelBatch:
    """Assemble a globally-sharded ChannelBatch from per-process local data.

    Multi-host entry point: each process passes the batch for ITS channels
    (the ``chan`` axis is split across processes; the ``vis`` axis must lie
    within a process).  On a single process this is just ``device_put``
    with the step's input shardings, which also skips the jit-time
    resharding of host arrays."""
    from jax.sharding import NamedSharding

    def dist(x, spec):
        sharding = NamedSharding(mesh, spec)
        if jax.process_count() == 1:
            return jax.device_put(jnp.asarray(x), sharding)
        return jax.make_array_from_process_local_data(sharding,
                                                      np.asarray(x))

    return ChannelBatch(*(dist(x, spec)
                          for x, spec in zip(local, BATCH_SPECS)))


class ChunkOverflowError(ValueError):
    """A (channel, slice) needs more chunks than the configured capacity."""


def chunk_channel(cfg: MultiChannelConfig, uv, sub_uv, w_plane, vis,
                  weights):
    """Plan one (channel, slice) into the padded chunk layout of the batch."""
    plan = mxu_gridder.plan_chunks_tiled(
        np.asarray(uv, np.int16), np.asarray(sub_uv, np.int16),
        np.asarray(w_plane, np.int16), np.asarray(vis, np.complex64),
        np.asarray(weights, np.float32), pixels=cfg.pixels,
        kernel_width=cfg.kernel_width, ts=cfg.rv, mc=cfg.chunk_size)
    NC = cfg.chunks_per_slice
    # plan_chunks pads its chunk axis to a power of two; trim to the chunks
    # that actually hold visibilities before re-padding to the batch layout.
    nc = int(plan.valid.any(axis=1).sum())
    if nc > NC:
        raise ChunkOverflowError(
            f"slice needs {nc} chunks > configured {NC}")

    def padnc(a):
        out = np.zeros((NC,) + a.shape[1:], a.dtype)
        out[:nc] = a[:nc]
        return out

    return (padnc(plan.uv), padnc(plan.sub_uv), padnc(plan.w_plane),
            padnc(plan.anchor), padnc(plan.valid), padnc(plan.weights),
            padnc(plan.vis))


def make_example_batch(cfg: MultiChannelConfig, num_channels: int,
                       seed: int = 0, base_frequency: float = 1.0e9,
                       vis_per_slice: int | None = None) -> ChannelBatch:
    """Synthesize a valid ChannelBatch for compile checks and benchmarks."""
    from .. import parameters, polarization
    from ..ops import wkernel
    from ..units import C_M_PER_S

    rng = np.random.default_rng(seed)
    C, S = num_channels, cfg.w_slices
    N, K, O, Pp = cfg.pixels, cfg.kernel_width, cfg.oversample, cfg.num_pols
    NC, Mc = cfg.chunks_per_slice, cfg.chunk_size
    if vis_per_slice is None:
        # Leave headroom: clustered data packs densely but not perfectly,
        # and small windows fragment sparse outskirts into partial chunks.
        vis_per_slice = NC * Mc // 4

    kernels = np.empty((C, cfg.w_planes, O, K), np.complex64)
    tapers = np.empty((C, N), np.float32)
    pixel_sizes = np.empty((C,), np.float32)
    mid_ws = np.empty((C, S), np.float32)
    fixed = parameters.FixedImageParameters((polarization.STOKES_I,) * Pp)
    fgp = parameters.FixedGridParameters(
        antialias_width=7.0, oversample=O, image_oversample=4,
        max_w=1000.0, kernel_width=K)
    gp = parameters.GridParameters(fgp, S, cfg.w_planes)
    for c in range(C):
        freq = base_frequency * (1 + 0.01 * c)
        wavelength = C_M_PER_S / freq
        ip = parameters.ImageParameters(fixed, wavelength,
                                        pixel_size=1.0 / (N * 16), pixels=N)
        kernels[c] = wkernel.make_convolution_kernel(ip, gp)
        tapers[c] = wkernel.taper(N, 7.0, O).astype(np.float32)
        pixel_sizes[c] = ip.pixel_size
        mid_ws[c] = wkernel.mid_w_values(ip, gp).astype(np.float32)

    lim = N // 2 - K - 1
    shape5 = (C, S, NC, Mc)
    out = {name: np.zeros(shape5 + tail, dt) for name, tail, dt in [
        ("uv", (2,), np.int32), ("sub_uv", (2,), np.int32),
        ("w_plane", (), np.int32), ("weights", (Pp,), np.float32),
        ("vis", (Pp,), np.complex64)]}
    anchors = np.zeros((C, S, NC, 2), np.int32)
    valids = np.zeros(shape5, bool)
    M = vis_per_slice
    for c in range(C):
        for s in range(S):
            while True:
                # clustered UV (realistic dense centre)
                uv = np.clip(rng.normal(scale=lim / 3, size=(M, 2)),
                             -lim, lim).astype(np.int16)
                sub = rng.integers(0, O, size=(M, 2)).astype(np.int16)
                wp = rng.integers(0, cfg.w_planes, size=M).astype(np.int16)
                vis = (rng.normal(size=(M, Pp))
                       + 1j * rng.normal(size=(M, Pp))).astype(np.complex64)
                wt = rng.uniform(0.5, 2.0, size=(M, Pp)).astype(np.float32)
                try:
                    (out["uv"][c, s], out["sub_uv"][c, s],
                     out["w_plane"][c, s], anchors[c, s], valids[c, s],
                     out["weights"][c, s], out["vis"][c, s]) = chunk_channel(
                        cfg, uv, sub, wp, vis, wt)
                    break
                except ValueError:
                    # Fragmentation exceeded the layout; thin the data.
                    M //= 2
                    if M == 0:
                        raise

    return ChannelBatch(
        kernel=jnp.asarray(kernels), taper1d=jnp.asarray(tapers),
        pixel_size=jnp.asarray(pixel_sizes), mid_w=jnp.asarray(mid_ws),
        uv=jnp.asarray(out["uv"]), sub_uv=jnp.asarray(out["sub_uv"]),
        w_plane=jnp.asarray(out["w_plane"]), anchor=jnp.asarray(anchors),
        valid=jnp.asarray(valids), weights=jnp.asarray(out["weights"]),
        vis=jnp.asarray(out["vis"]))
