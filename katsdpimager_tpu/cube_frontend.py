"""Cube-mode orchestration: image a spectral cube in sharded device waves.

The general frontend (:mod:`.frontend`) drives one channel at a time with
host-side control between stages — maximum flexibility (per-channel PSF
patches, direct prediction, primary beam).  This module is the production
fast path for large cubes (BASELINE configs 4-5): channels are processed in
waves of ``mesh chan-size``, each wave running the FULL pipeline
(:mod:`.parallel.cube`) in two jitted sharded calls, with beam fitting as
the only host work in between.

Deviations from the per-channel path, by design:

- the CLEAN PSF patch is auto-sized per WAVE (not per channel): a
  phase-A jit measures the PSFs, the host snaps the largest support to a
  bucket, and a phase-B jit compiled for that bucket runs the major
  cycles.  ``--cube-psf-patch N`` forces a fixed size and runs the
  single-jit wave instead;
- model prediction uses degridding (fully on device); direct prediction
  remains available in the per-channel path.

``--subtract`` continuum subtraction runs on device inside the wave
(:func:`..parallel.cube._predict_subtract_slices`) and ``--primary-beam``
correction inside the sharded restore stage.

Natural, uniform and robust weighting are all supported (the robust
mean-weight pass runs on device).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List

import numpy as np
import jax.numpy as jnp

from . import frontend, native, parameters, polarization, sky_model
from .ops import clean as clean_ops
from .ops import mxu_gridder, predict, wkernel
from .parallel import cube, make_mesh
from .parallel.multichannel import ChannelBatch, ChunkOverflowError

logger = logging.getLogger(__name__)


def _plan_layout(reader, num_channels: int, cfg_template: dict) -> dict:
    """Measure chunk requirements over the wave and size NC with headroom.

    Uses coordinates-only reads (``slice_coords``) — the probe never
    touches the vis/weights payload, ~80% of the slice bytes at P=4."""
    ts = cfg_template["rv"]
    max_nc = 1
    for c in range(num_channels):
        for s in range(reader.num_w_slices(c)):
            cu, _cs, _cw = reader.slice_coords(c, s)
            if len(cu) == 0:
                continue
            max_nc = max(max_nc, mxu_gridder.plan_chunks_tiled_count(
                cu, pixels=cfg_template["pixels"],
                kernel_width=cfg_template["kernel_width"], ts=ts,
                mc=cfg_template["chunk_size"]))
    # Dense gridding cost is proportional to the chunk CAPACITY, so keep
    # headroom tight (25%, rounded to the scan group size); a later wave
    # that overflows triggers a grow-and-recompile in run_cube instead.
    cfg_template["chunks_per_slice"] = max(128, -(-int(max_nc * 1.25)
                                                  // 128) * 128)
    return cfg_template


def _tile_for(kernel_width: int) -> int:
    """Smallest power-of-two tile >= 64 covering the kernel (the dense
    gridder requires ts >= K and a power-of-two window)."""
    ts = 64
    while ts < kernel_width:
        ts *= 2
    return ts


#: Snap auto-sized PSF patches to a few buckets so phase-B waves compile
#: at most once per bucket.
_PATCH_BUCKETS = (17, 33, 65, 129, 257, 513)


def _patch_bucket(need: int, pixels: int) -> int:
    cap = pixels - 1 if pixels % 2 == 0 else pixels
    for b in _PATCH_BUCKETS:
        if b >= need and b <= cap:
            return b
    return min(cap, _PATCH_BUCKETS[-1])


def _make_fns(mesh, cfg, auto_patch):
    """(psf_fn, wave_fn, restore_fn) for a config; one of psf/wave is None."""
    if auto_patch:
        return (cube.make_wave_psf(mesh, cfg), None,
                cube.make_wave_restore(mesh, cfg))
    return (None, cube.make_wave_image(mesh, cfg),
            cube.make_wave_restore(mesh, cfg))


def _wave_buffers(arena: dict, cfg: cube.CubeConfig, C: int) -> tuple:
    """Zeroed batch arrays for one wave, reused across waves.

    Per-wave ``np.zeros`` of the ~GB batch pays first-touch page faults
    every wave (severe on hosts that reclaim cold pages); a reused arena
    pays them once and re-zeroes warm memory instead.  The caller owns
    double-buffering (the prefetch worker packs wave N+1 while wave N's
    arrays are still being consumed)."""
    S, N = cfg.w_slices, cfg.pixels
    NC, Mc, Pp = cfg.chunks_per_slice, cfg.chunk_size, cfg.num_pols
    key = (C, S, N, NC, Mc, Pp, cfg.w_planes, cfg.oversample,
           cfg.kernel_width)
    if arena.get("key") != key:
        arena.clear()
        arena["key"] = key
        arena["arrs"] = (
            np.zeros((C, cfg.w_planes, cfg.oversample, cfg.kernel_width),
                     np.complex64),              # kernels
            np.zeros((C, N), np.float32),        # tapers
            np.zeros((C,), np.float32),          # psizes
            np.zeros((C, S), np.float32),        # midws
            np.zeros((C, S, NC, Mc, 2), np.int32),   # uv
            np.zeros((C, S, NC, Mc, 2), np.int32),   # sub
            np.zeros((C, S, NC, Mc), np.int32),      # wp
            np.zeros((C, S, NC, 2), np.int32),       # anc
            np.zeros((C, S, NC, Mc), bool),          # val
            np.zeros((C, S, NC, Mc, Pp), np.float32),    # wts
            np.zeros((C, S, NC, Mc, Pp), np.complex64),  # vis
        )
    else:
        for a in arena["arrs"][4:]:
            a.fill(0)   # scatter targets must start zeroed
    return arena["arrs"]


def pack_wave_arrays(cfg: cube.CubeConfig, reader, image_ps, grid_ps,
                     wave_channels: List[int], start: int,
                     arena: dict = None) -> tuple:
    """Pack a wave of channels into the static chunked batch layout.

    Pure numpy (no device transfers), so the cube prefetch worker can run
    it for wave N+1 while the device executes wave N; raises
    ChunkOverflowError when the wave does not fit ``cfg.chunks_per_slice``
    (the caller grows the layout and repacks)."""
    C, S, N = len(wave_channels), cfg.w_slices, cfg.pixels
    NC, Mc, Pp = cfg.chunks_per_slice, cfg.chunk_size, cfg.num_pols
    (kernels, tapers, psizes, midws, uv, sub, wp, anc, val, wts,
     vis) = _wave_buffers(arena if arena is not None else {}, cfg, C)

    for i, ch in enumerate(wave_channels):
        rel = ch - start
        ip, gp = image_ps[rel], grid_ps[rel]
        kernels[i] = wkernel.make_convolution_kernel(ip, gp)
        tapers[i] = wkernel.taper(
            N, gp.fixed.antialias_width, gp.fixed.oversample
        ).astype(np.float32)
        psizes[i] = ip.pixel_size
        midws[i] = wkernel.mid_w_values(ip, gp).astype(np.float32)
        for s in range(min(S, reader.num_w_slices(rel))):
            # Coordinates-only planning pass, then payloads streamed in
            # bounded blocks (spill readers recycle one buffer): host
            # memory stays flat regardless of slice size.
            cu, cs, cw = reader.slice_coords(rel, s)
            if len(cu) == 0:
                continue
            use_native = native.available()
            if use_native:
                # Parallel C++ plan + coordinate scatter straight into
                # the batch views (bitwise-identical to the numpy path).
                n_chunks, rc, rs = native.pack_slice_coords(
                    cu, cs, cw, pixels=N, kernel_width=cfg.kernel_width,
                    ts=cfg.rv, mc=Mc, out_uv=uv[i, s], out_sub=sub[i, s],
                    out_wp=wp[i, s], out_anchor=anc[i, s],
                    out_valid=val[i, s])
                if n_chunks > NC:
                    raise ChunkOverflowError(
                        f"slice needs {n_chunks} chunks > configured "
                        f"{NC}")
            else:
                asg = mxu_gridder.plan_chunks_tiled_coords(
                    cu, pixels=N, kernel_width=cfg.kernel_width,
                    ts=cfg.rv, mc=Mc)
                if asg["n_chunks"] > NC:
                    raise ChunkOverflowError(
                        f"slice needs {asg['n_chunks']} chunks > "
                        f"configured {NC}")
                # n_chunks <= NC, so every chunk index is in range: the
                # scatter destinations are the sorted enumeration
                # (nearly sequential writes), no filtering needed.
                order = asg["order"]
                dst = (asg["chunk_of"], asg["slot_of"])
                uv[i, s][dst] = cu[order]
                sub[i, s][dst] = cs[order]
                wp[i, s][dst] = cw[order]
                bound = min(NC, len(asg["anchor"]))
                anc[i, s, :bound] = asg["anchor"][:bound]
                val[i, s, :bound] = asg["valid"][:bound]
                rc, rs = asg["row_chunk"], asg["row_slot"]
            row = 0
            for blk in reader.iter_slice(rel, s, 1 << 20):
                m = len(blk)
                rr = slice(row, row + m)
                if use_native:
                    native.place_payload(rc[rr], rs[rr], blk.weights,
                                         blk.vis, wts[i, s], vis[i, s])
                else:
                    wts[i, s][rc[rr], rs[rr]] = blk.weights
                    vis[i, s][rc[rr], rs[rr]] = blk.vis
                row += m
    return (kernels, tapers, psizes, midws, uv, sub, wp, anc, val, wts,
            vis)


def batch_from_arrays(arrs: tuple) -> ChannelBatch:
    """Move packed wave arrays to the device (from the main thread; the
    prefetch worker only packs host arrays)."""
    (kernels, tapers, psizes, midws, uv, sub, wp, anc, val, wts,
     vis) = arrs
    return ChannelBatch(
        kernel=jnp.asarray(kernels), taper1d=jnp.asarray(tapers),
        pixel_size=jnp.asarray(psizes), mid_w=jnp.asarray(midws),
        uv=jnp.asarray(uv), sub_uv=jnp.asarray(sub),
        w_plane=jnp.asarray(wp), anchor=jnp.asarray(anc),
        valid=jnp.asarray(val), weights=jnp.asarray(wts),
        vis=jnp.asarray(vis))


def build_wave_batch(cfg: cube.CubeConfig, reader, image_ps, grid_ps,
                     wave_channels: List[int], start: int) -> ChannelBatch:
    """Pack a wave and move it to the device (single-shot convenience)."""
    return batch_from_arrays(pack_wave_arrays(
        cfg, reader, image_ps, grid_ps, wave_channels, start))


def run_cube(args, dataset, writer, devices=None) -> None:
    """Image the requested channel range in sharded waves over
    ``devices`` (default: all of them)."""
    input_polarizations = dataset.polarizations()
    mueller = (polarization.polarization_matrix(args.stokes,
                                                input_polarizations), None)
    if dataset.has_feed_angles():
        mueller = polarization.polarization_matrices(args.stokes,
                                                     input_polarizations)
    array_p = dataset.array_parameters()
    if args.stop_channel is None:
        args.stop_channel = dataset.num_channels()
    fixed_image_p = parameters.FixedImageParameters(tuple(args.stokes),
                                                    args.precision)
    from .units import parse_quantity

    max_w = (array_p.longest_baseline if args.max_w is None
             else parse_quantity(args.max_w).value)
    fixed_grid_p = parameters.FixedGridParameters(
        args.aa_width, args.grid_oversample, args.kernel_image_oversample,
        max_w, args.kernel_width, True, None)

    mesh = make_mesh(devices, vis_shards=getattr(args, "vis_shards", 1))
    wave_size = mesh.shape["chan"]
    clean_mode = (clean_ops.CLEAN_I if args.clean_mode == "I"
                  else clean_ops.CLEAN_SUMSQ)
    clean_p = parameters.CleanParameters(
        args.minor, args.loop_gain, args.major_gain, args.threshold,
        clean_mode, args.psf_cutoff, args.psf_limit, args.border)

    # Continuum-subtraction sky model (reference frontend.py:544-549)
    if args.subtract == "auto":
        subtract_model = dataset.sky_model()
    elif args.subtract is not None:
        subtract_model = sky_model.open_sky_model(args.subtract)
    else:
        subtract_model = None

    # Primary-beam model (reference frontend.py:532-539)
    beams = None
    if getattr(args, "primary_beam", "none") in ("meerkat", "meerkat:1"):
        from . import primary_beam

        band = dataset.band()
        if band is None:
            raise ValueError("Data set does not specify a band, so "
                             "--primary-beam cannot be used")
        beams = primary_beam.meerkat_v1_beam(band)
    pol_index = [polarization.STOKES_IQUV.index(p)
                 for p in fixed_image_p.polarizations]

    wave_fn = None
    psf_fn = None
    restore_fn = None
    cfg = None
    #: 0 requests per-wave auto-sizing (reference per-channel semantics)
    auto_patch = getattr(args, "cube_psf_patch", 65) == 0
    clean_fns = {}   # patch size -> compiled phase-B wave
    channels = list(range(args.start_channel, args.stop_channel))

    # ALL waves must share the static (w_slices, w_planes) geometry — one
    # compilation serves the whole cube — so take the maximum over the
    # full channel range (pure parameter math; no data is read here).
    all_params = [frontend.ChannelParameters(args, dataset, ch, array_p,
                                             fixed_image_p, fixed_grid_p)
                  for ch in channels]
    w_slices = max(p.grid_p.w_slices for p in all_params)
    w_planes = max(p.grid_p.w_planes for p in all_params)

    # Waves to run (resume: drop fully-written waves up front so the
    # prefetch pipeline below never preprocesses a skipped wave).
    waves = []
    for wave_start in range(0, len(channels), wave_size):
        wave_channels = channels[wave_start:wave_start + wave_size]
        if all(writer.channel_already_done(dataset, ch)
               for ch in wave_channels):
            logger.info("Skipping wave %s: already done", wave_channels)
            continue
        start = wave_channels[0]
        stop = wave_channels[-1] + 1
        image_ps = [all_params[ch - channels[0]].image_p
                    for ch in range(start, stop)]
        grid_ps = [parameters.GridParameters(fixed_grid_p, w_slices,
                                             w_planes)
                   for _ in range(start, stop)]
        waves.append((wave_channels, start, stop, image_ps, grid_ps))

    import time as _time

    # The wave layout (chunk capacity) is discovered on the first wave and
    # can grow on overflow; the prefetch worker reads it from this box when
    # its wave's preprocessing finishes (a stale/None read just means the
    # main thread packs that wave itself).
    cfg_box = [None]
    # Double-buffered pack arenas: the worker packs wave N+1 into one
    # arena while wave N's arrays (the other arena) are still being
    # transferred/consumed.
    arenas = ({}, {})

    def _prepare_wave(wave, wave_idx):
        """Load + compress a wave, then pack it into the static batch
        layout — ALL host data-plane work, off the main thread."""
        wave_channels, start, stop, image_ps, grid_ps = wave
        t0 = _time.monotonic()
        collector = frontend.preprocess_visibilities(
            dataset, args, start, stop, image_ps, grid_ps, mueller)
        reader = collector.reader()
        arrs = None
        pack_cfg = cfg_box[0]
        if pack_cfg is not None:
            padded = wave_channels + [wave_channels[-1]] * (
                wave_size - len(wave_channels))
            try:
                arrs = pack_wave_arrays(pack_cfg, reader, image_ps,
                                        grid_ps, padded, start,
                                        arena=arenas[wave_idx % 2])
            except ChunkOverflowError:
                arrs = None   # main thread grows the layout and repacks
        return reader, arrs, pack_cfg, _time.monotonic() - t0

    # Host/device pipelining (reference frontend.py:53-77's load/preprocess
    # overlap, lifted to wave granularity): while the device executes wave
    # N, a single worker thread loads + compresses + packs wave N+1.  The
    # host data plane and the device waves then run concurrently, so cube
    # throughput is max(host, device) per wave instead of their sum.
    import concurrent.futures

    prefetch = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    next_reader = prefetch.submit(_prepare_wave, waves[0], 0) if waves \
        else None

    for wave_idx, wave in enumerate(waves):
        wave_channels, start, stop, image_ps, grid_ps = wave
        # Pad the last wave by repeating the final channel.
        padded = wave_channels + [wave_channels[-1]] * (
            wave_size - len(wave_channels))

        t_block0 = _time.monotonic()
        reader, arrs, packed_cfg, t_host = next_reader.result()
        t_blocked = _time.monotonic() - t_block0
        if wave_idx + 1 < len(waves):
            next_reader = prefetch.submit(_prepare_wave,
                                          waves[wave_idx + 1],
                                          wave_idx + 1)
        t_wave0 = _time.monotonic()

        if cfg is None:
            template = dict(
                pixels=image_ps[0].pixels,
                num_pols=fixed_image_p.num_polarizations,
                kernel_width=args.kernel_width,
                oversample=args.grid_oversample,
                w_planes=w_planes, w_slices=w_slices,
                chunk_size=256, rv=_tile_for(args.kernel_width),
                ru=_tile_for(args.kernel_width),
                majors=args.major, minor=args.minor,
                patch=(getattr(args, "cube_psf_patch", 65) or 65),
                psf_core=64,
                border_pixels=round(args.border * image_ps[0].pixels),
                loop_gain=args.loop_gain, major_gain=args.major_gain,
                threshold_sigma=args.threshold, clean_mode=clean_mode,
                weight_type=args.weight_type,
                robustness=args.robustness,
                num_sources=(-(-len(subtract_model) // 8) * 8
                             if subtract_model is not None else 0),
                primary_beam=beams is not None,
                primary_beam_cutoff=getattr(args, "primary_beam_cutoff",
                                            0.1),
            )
            template = _plan_layout(reader, len(image_ps), template)
            cfg = cube.CubeConfig(**template)
            cfg_box[0] = cfg
            psf_fn, wave_fn, restore_fn = _make_fns(mesh, cfg, auto_patch)
            logger.info("Cube config: %s", cfg)

        while True:
            try:
                if arrs is None or packed_cfg != cfg:
                    # Not packed by the prefetch worker (first wave, a
                    # worker-side overflow, or a layout change since).
                    arrs = pack_wave_arrays(cfg, reader, image_ps,
                                            grid_ps, padded, start,
                                            arena=arenas[wave_idx % 2])
                    packed_cfg = cfg
                batch = batch_from_arrays(arrs)
                break
            except ChunkOverflowError:
                # A wave overflowed the chunk capacity: grow + recompile
                # (rare; capacity-proportional gridding cost makes tight
                # layouts worth the occasional recompile).
                arrs = None
                cfg = dataclasses.replace(
                    cfg, chunks_per_slice=cfg.chunks_per_slice * 2)
                cfg_box[0] = cfg
                logger.info("Growing chunk capacity to %d (recompiling)",
                            cfg.chunks_per_slice)
                psf_fn, wave_fn, restore_fn = _make_fns(mesh, cfg,
                                                        auto_patch)
                clean_fns.clear()

        sky = None
        if subtract_model is not None:
            C, Smax, Pp = len(padded), cfg.num_sources, cfg.num_pols
            lmn_all = subtract_model.lmn(
                dataset.phase_centre()).astype(np.float32)
            ns = len(lmn_all)
            sky_lmn = np.zeros((C, Smax, 3), np.float32)
            sky_flux = np.zeros((C, Smax, Pp), np.float32)
            scales = np.zeros((C, 3), np.float32)
            for i, ch in enumerate(padded):
                ip, gp = image_ps[ch - start], grid_ps[ch - start]
                flux = subtract_model.flux_density(
                    ip.wavelength)[:, pol_index]
                taper_scale = float(ip.image_size * gp.fixed.oversample)
                taper = (np.sinc(lmn_all[:, 0] / taper_scale)
                         * np.sinc(lmn_all[:, 1] / taper_scale))
                sky_lmn[i, :ns] = lmn_all
                sky_flux[i, :ns] = (flux * taper[:, None]).astype(np.float32)
                scales[i] = predict.uvw_scale_bias(ip, gp)
            sky = cube.SkyBatch(jnp.asarray(sky_lmn),
                                jnp.asarray(sky_flux), jnp.asarray(scales))

        if auto_patch:
            psf_res = psf_fn(batch)
            psf_np = np.asarray(psf_res.psf)
            boxes = [clean_ops.psf_patch(psf_np[i], args.psf_cutoff,
                                         args.psf_limit)
                     for i in range(len(wave_channels))]
            need = max(max(b[1], b[2]) for b in boxes)
            patch = _patch_bucket(need, cfg.pixels)
            logger.info("Wave %s: PSF patch %dx%d (need %d)",
                        wave_channels, patch, patch, need)
            if patch not in clean_fns:
                clean_fns[patch] = cube.make_wave_clean(mesh, cfg, patch)
            residual, model, noise_j, minor_j = clean_fns[patch](
                batch, psf_res, sky)
            half = cfg.pixels // 2
            c0 = half - cfg.psf_core // 2
            cores = psf_np[:, :, c0:c0 + cfg.psf_core,
                           c0:c0 + cfg.psf_core]
            ms, fitted_beams = cube.fit_wave_beams(cores)
            result = cube.WaveResult(residual, model, jnp.asarray(cores),
                                     noise_j, psf_res.psf_peak, minor_j,
                                     psf_res.weights_noise,
                                     psf_res.normalized_noise)
            patch_used = patch
        else:
            result = (wave_fn(batch, sky) if sky is not None
                      else wave_fn(batch))
            ms, fitted_beams = cube.fit_wave_beams(
                np.asarray(result.psf_core))
            patch_used = cfg.patch
        restore_args = [result.model, result.residual, jnp.asarray(ms)]
        pbeams = None
        if beams is not None:
            N = cfg.pixels
            pbeams = np.empty((len(padded), N, N), np.float32)
            for i, ch in enumerate(padded):
                ip = image_ps[ch - start]
                coords = (np.arange(N) - N / 2) * ip.pixel_size
                from .units import C_M_PER_S

                pbeams[i] = beams.sample_grid(
                    coords, coords, C_M_PER_S / ip.wavelength)
            restore_args.append(jnp.asarray(pbeams))
        final = np.asarray(restore_fn(*restore_args))
        noise = np.asarray(result.noise)
        psf_peaks = np.asarray(result.psf_peak)
        minors = np.asarray(result.minor)
        w_noise = np.asarray(result.weights_noise)
        # Match the per-channel path (frontend.make_weights) and the
        # reference (frontend.py:101-102): thermal noise derived from
        # weights must be scaled by the dataset's weight calibration.
        wscale = dataset.weight_scale()
        if wscale is not None:
            w_noise = np.where(w_noise < 0, w_noise, w_noise * wscale)
        norm_noise = np.asarray(result.normalized_noise)
        for i, ch in enumerate(wave_channels):
            rel = ch - start
            image_p = image_ps[rel]
            if np.any(psf_peaks[i] == 0):
                logger.info("Skipping channel %d which has no usable data", ch)
                writer.skip_channel(dataset, image_p, ch)
                continue
            writer.write_fits_image("clean", "clean image", dataset,
                                    final[i], image_p, ch, fitted_beams[i])
            pbeam = (pbeams[i] if pbeams is not None
                     else np.ones(final[i].shape[-2:], final.dtype))
            peak = frontend.find_peak(final[i], pbeam, float(noise[i]))
            totals = frontend.get_totals(image_p, final[i], fitted_beams[i])
            wn = w_noise[i]
            writer.statistics(
                dataset, ch, major=cfg.majors, minor=int(minors[i]),
                peak=peak, totals=totals, noise=float(noise[i]),
                weights_noise=(None if wn < 0 else float(wn)),
                normalized_noise=float(norm_noise[i]),
                psf_patch_size=(patch_used, patch_used),
                compressed_vis=sum(
                    reader.len(rel, s) for s in range(w_slices)),
                image_parameters=image_p, grid_parameters=grid_ps[rel],
                clean_parameters=clean_p, restoring_beam=fitted_beams[i])
        reader.close()
        # End-to-end accounting (VERDICT r2 item 2): host data-plane time
        # (preprocess + pack in the worker) vs how long the pipeline
        # actually WAITED for it (overlap hides the difference), plus
        # device+write time for this wave.
        t_rest = _time.monotonic() - t_wave0
        logger.info(
            "Wave %s timing: host preprocess+pack %.1fs (pipeline blocked "
            "%.1fs), device+write %.1fs -> %.2f s/channel",
            wave_channels, t_host, t_blocked, t_rest,
            (t_blocked + t_rest) / len(wave_channels))
    prefetch.shutdown(wait=True)
