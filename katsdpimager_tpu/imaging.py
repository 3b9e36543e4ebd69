"""Per-channel imaging pipeline: composition of the device operators.

Replaces the reference's ``imaging.py`` (``ImagingTemplate`` /
``Imaging(OperationSequence)`` slot-aliasing machinery) with a plain object
holding jnp array state and calling jitted operator functions.  The method
surface mirrors the ~25 calls the frontend makes on the reference class
(reference imaging.py:226-420), so the orchestration layer reads the same.

Static-shape discipline: visibility chunks are padded to a fixed
``vis_block`` so each operator compiles once per channel geometry; padded
entries carry zero vis/weights and are no-ops in every operator.
"""

from __future__ import annotations

from typing import Optional

import os

import numpy as np
import jax
import jax.numpy as jnp

from . import parameters
from .ops import beam as beam_ops
from .ops import clean as clean_ops
from .ops import fourier, gridder, mxu_gridder, predict, wkernel
from .ops import weights as weight_ops


def _pad_to(arr: np.ndarray, n: int):
    """Pad the leading axis to length n with zeros."""
    if arr.shape[0] == n:
        return arr
    pad = [(0, n - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def _round_block(n: int, minimum: int = 1024) -> int:
    """Round up to a power of two to bound the number of jit specialisations."""
    size = minimum
    while size < n:
        size *= 2
    return size


class Imaging:
    """Imaging state and operations for one channel.

    Buffers (jnp arrays): ``grid`` (P,N,N) complex, ``dirty``/``model``/
    ``psf`` (P,N,N) real, ``weights_grid`` (P,N,N) float32, ``beam_power``
    (N,N) real.  CLEAN state lives in a :class:`..ops.clean.CleanState`.
    """

    def __init__(self, image_p: parameters.ImageParameters,
                 grid_p: parameters.GridParameters,
                 weight_p: parameters.WeightParameters,
                 clean_p: parameters.CleanParameters,
                 max_vis: int = 1 << 20):
        self.image_p = image_p
        self.grid_p = grid_p
        self.weight_p = weight_p
        self.clean_p = clean_p
        self.max_vis = max_vis

        N = image_p.pixels
        P = image_p.fixed.num_polarizations
        rdtype = image_p.fixed.real_dtype
        cdtype = image_p.fixed.complex_dtype
        self.pixels = N
        self.num_pols = P
        self._rdtype = rdtype
        self._cdtype = cdtype

        # Per-channel constants, generated on host once and uploaded.
        self.kernel = jnp.asarray(
            wkernel.make_convolution_kernel(image_p, grid_p))
        beta = wkernel.default_beta(grid_p.fixed.antialias_width)
        self.taper1d = jnp.asarray(
            wkernel.taper(N, grid_p.fixed.antialias_width,
                          grid_p.fixed.oversample, beta).astype(rdtype))
        self.mid_w = wkernel.mid_w_values(image_p, grid_p)
        self._uv_scale, self._w_scale, self._w_bias = predict.uvw_scale_bias(
            image_p, grid_p)

        # State buffers
        self.grid = jnp.zeros((P, N, N), cdtype)
        self.dirty = jnp.zeros((P, N, N), rdtype)
        self.model = jnp.zeros((P, N, N), rdtype)
        self.psf = jnp.zeros((P, N, N), rdtype)
        self.weights = weight_ops.Weights(
            weight_p.weight_type, P, N, weight_p.robustness)
        self.beam_power: Optional[jnp.ndarray] = None

        self._clean_cfg: Optional[clean_ops.CleanConfig] = None
        self._clean_state: Optional[clean_ops.CleanState] = None
        self._psf_patch_arr: Optional[jnp.ndarray] = None
        self._sky_lmn: Optional[jnp.ndarray] = None
        self._sky_flux: Optional[jnp.ndarray] = None
        self._model_lmn: Optional[jnp.ndarray] = None
        self._model_flux: Optional[jnp.ndarray] = None

        # Matmul gridding: window sizes scale down for small images; chunk
        # plans are cached per w_slice (coordinates are fixed across major
        # cycles, only vis payloads change).
        r = min(64, max(8, N // 8))
        self._mxu = mxu_gridder.MxuGridder(
            pixels=N, kernel_width=grid_p.fixed.kernel_width, num_pols=P,
            rv=r, ru=r, mc=256)
        self._plans: dict = {}
        self._dw_cache: dict = {}

    # ------------------------------------------------------------------
    # clearing

    def clear_grid(self):
        self.grid = jnp.zeros_like(self.grid)

    def clear_dirty(self):
        self.dirty = jnp.zeros_like(self.dirty)

    def clear_model(self):
        self.model = jnp.zeros_like(self.model)

    # ------------------------------------------------------------------
    # weights

    def clear_weights(self):
        self.weights.clear()
        self._dw_cache.clear()

    def grid_weights(self, uv: np.ndarray, weights: np.ndarray):
        n = _round_block(len(uv), min(self.max_vis, 1 << 14))
        self.weights.accumulate(_pad_to(np.asarray(uv), n),
                                _pad_to(np.asarray(weights), n))

    def finalize_weights(self):
        return self.weights.finalize()

    @property
    def weights_grid(self):
        return self.weights.grid

    # ------------------------------------------------------------------
    # gridding / degridding / prediction

    def _padded_chunk(self, chunk):
        n = _round_block(len(chunk.uv), min(self.max_vis, 1 << 14))
        return (jnp.asarray(_pad_to(np.asarray(chunk.uv), n)),
                jnp.asarray(_pad_to(np.asarray(chunk.sub_uv), n)),
                jnp.asarray(_pad_to(np.asarray(chunk.w_plane), n)))

    def grid_chunk(self, chunk, vis: np.ndarray):
        """Grid (pre-weighted) visibilities with the scatter gridder;
        ``vis`` is (n, P) complex or a real array (for PSF gridding of the
        weights).  Prefer :meth:`grid_slice` (matmul path)."""
        uv, sub_uv, w_plane = self._padded_chunk(chunk)
        n = uv.shape[0]
        vis = np.asarray(vis).astype(np.complex64)
        self.grid = gridder.grid_vis(
            self.grid, self.kernel, self.weights.grid, uv, sub_uv, w_plane,
            jnp.asarray(_pad_to(vis, n)), pixels=self.pixels)

    @staticmethod
    def _plan_key(chunk, w_slice: int, block: int):
        """Plan cache key: (w_slice, block, size, coordinate fingerprint).

        The fingerprint (a strided sum of the uv coordinates) guards the
        cache against a caller that re-plans with *changed* coordinates of
        equal length — coordinates are fixed across major cycles today,
        but nothing else asserts it."""
        uv = np.asarray(chunk.uv)
        n = len(uv)
        fp = int(uv[:: max(1, n // 64)].sum(dtype=np.int64)) if n else 0
        return (w_slice, block, n, fp)

    def _slice_plan(self, chunk, w_slice: int, block: int = 0):
        """(host_plan, device_plan) pair; the device mirror is uploaded
        once so per-pass grid/degrid calls move no plan data."""
        key = self._plan_key(chunk, w_slice, block)
        entry = self._plans.get(key)
        if entry is None:
            host = self._mxu.plan(chunk.uv, chunk.sub_uv, chunk.w_plane,
                                  np.asarray(chunk.vis, np.complex64),
                                  chunk.weights)
            # The chunked vis payload is never read through the plan
            # (grid/degrid always take vis_chunked); drop it so the
            # per-block plan cache stays bounded by coordinates, not data.
            host = host._replace(vis=host.vis[:0])
            entry = (host, self._mxu.upload_plan(host))
            self._plans[key] = entry
        return entry

    def grid_slice(self, chunk, vis, w_slice: int, block: int = 0):
        """Grid a (channel, w_slice) visibility set (or one streamed block
        of it) via the dense-matmul gridder.  ``vis`` may be numpy or
        device-resident."""
        host_plan, plan = self._slice_plan(chunk, w_slice, block)
        if plan.uv.shape[0] == 0:
            return
        vis = jnp.asarray(vis, jnp.complex64)
        vis_chunked = self._mxu.chunk_vis(plan, vis)
        key = self._plan_key(chunk, w_slice, block)
        dw = self._dw_cache.get(key)
        if dw is None and self._mxu.mode == "dense":
            wg = np.asarray(self.weights.grid)
            half = self.pixels // 2
            dw_np = wg[:, host_plan.uv[..., 1] + half,
                       host_plan.uv[..., 0] + half].transpose(1, 2, 0)
            dw = jnp.asarray(np.ascontiguousarray(dw_np, np.float32))
            self._dw_cache[key] = dw
        self.grid = self._mxu.grid(self.grid, self.kernel,
                                   self.weights.grid, plan,
                                   vis_chunked=vis_chunked, dw_chunks=dw)

    def degrid_slice(self, chunk, vis, model_grid, w_slice: int,
                     block: int = 0):
        """Subtract degridded model visibilities for a slice (or one
        streamed block); the result stays on device."""
        _host_plan, plan = self._slice_plan(chunk, w_slice, block)
        vis = jnp.asarray(vis)
        vis_chunked = self._mxu.chunk_vis(plan, vis)
        out_chunked = self._mxu.degrid(model_grid, self.kernel, plan,
                                       vis_chunked)
        return self._mxu.unchunk_vis(plan, out_chunked, len(vis))

    def predict_chunk(self, chunk, vis, w_slice: int, lmn, flux):
        """Subtract a direct DFT prediction from ``vis``; the result stays
        on device."""
        if lmn is None or lmn.shape[0] == 0:
            return vis
        uv, sub_uv, w_plane = self._padded_chunk(chunk)
        n = uv.shape[0]
        vis_j = jnp.asarray(vis, jnp.complex64)
        vis_j = jnp.pad(vis_j, ((0, n - vis_j.shape[0]), (0, 0)))
        weights_j = jnp.asarray(
            _pad_to(np.asarray(chunk.weights).astype(np.float32), n))
        out = predict.predict_subtract(
            lmn, flux, uv, sub_uv, w_plane, vis_j, weights_j,
            jnp.float32(self._uv_scale), jnp.float32(self._w_scale),
            jnp.float32(self._w_bias + self.mid_w[w_slice]),
            oversample=self.grid_p.fixed.oversample)
        return out[: len(vis)]

    def degrid_chunk(self, chunk, vis, model_grid):
        """Subtract degridded model visibilities from ``vis``."""
        uv, sub_uv, w_plane = self._padded_chunk(chunk)
        n = uv.shape[0]
        vis_j = jnp.asarray(_pad_to(np.asarray(vis).astype(np.complex64), n))
        weights_j = jnp.asarray(
            _pad_to(np.asarray(chunk.weights).astype(np.float32), n))
        out = gridder.degrid_vis(
            model_grid, self.kernel, uv, sub_uv, w_plane, weights_j, vis_j,
            pixels=self.pixels)
        return np.asarray(out[: len(vis)])

    # ------------------------------------------------------------------
    # model component extraction (for the major cycle)

    def set_sky_model(self, lmn: np.ndarray, flux: np.ndarray):
        """Continuum-subtraction sky model (reference imaging.py:311-318)."""
        self._sky_lmn = jnp.asarray(lmn)
        self._sky_flux = jnp.asarray(flux)

    def model_to_predict(self):
        """Extract CLEAN components from the model image for direct
        prediction (host round trip, as in the reference).

        CLEAN components sit on image pixels, so the exact trig-free
        predict path applies (``predict_subtract_exact``): integer pixel
        indices are kept alongside lmn.  Zero-flux padding rows are
        inert in both paths."""
        model = np.asarray(self.model)
        lmn, flux, xi, yi = predict.extract_sky_image(
            self.image_p, self.grid_p, model, return_pixels=True)
        if len(lmn):
            # pad to limit recompiles
            s = _round_block(len(lmn), 256)
            lmn = _pad_to(lmn, s)
            flux = _pad_to(flux, s)
            xi = _pad_to(xi, s)
            yi = _pad_to(yi, s)
        self._model_lmn = jnp.asarray(lmn)
        self._model_flux = jnp.asarray(flux)
        self._model_xi = jnp.asarray(xi)
        self._model_yi = jnp.asarray(yi)

    def model_to_grid(self, w: float):
        """FFT the model image to a grid for degridding."""
        return fourier.image_to_grid(
            self.model, self.taper1d, jnp.asarray(w, self._rdtype),
            jnp.asarray(self.image_p.pixel_size, self._rdtype),
            pixels=self.pixels)

    def continuum_predict(self, chunk, vis, w_slice: int):
        return self.predict_chunk(chunk, vis, w_slice, self._sky_lmn,
                                  self._sky_flux)

    def model_predict(self, chunk, vis, w_slice: int):
        if self._model_lmn.shape[0] == 0:
            return vis
        # Default: the blocked matmul DFT (predict_subtract).  The
        # trig-free exact path is phase-exact but gathers a (block, S)
        # root-of-unity table; it is an opt-in accuracy tool
        # (KTPU_PREDICT_EXACT=1), and the two agree to f32 rounding.
        if os.environ.get("KTPU_PREDICT_EXACT", "0") != "1":
            return self.predict_chunk(chunk, vis, w_slice,
                                      self._model_lmn, self._model_flux)
        uv, sub_uv, w_plane = self._padded_chunk(chunk)
        n = uv.shape[0]
        vis_j = jnp.asarray(vis, jnp.complex64)
        vis_j = jnp.pad(vis_j, ((0, n - vis_j.shape[0]), (0, 0)))
        weights_j = jnp.asarray(
            _pad_to(np.asarray(chunk.weights).astype(np.float32), n))
        out = predict.predict_subtract_exact(
            self._model_xi, self._model_yi, self._model_lmn[:, 2],
            self._model_flux, uv, sub_uv, vis_j, weights_j, w_plane,
            jnp.float32(self._w_scale),
            jnp.float32(self._w_bias + self.mid_w[w_slice]),
            pixels=self.pixels, oversample=self.grid_p.fixed.oversample,
            w_planes=self.grid_p.w_planes)
        return out[: len(vis)]

    # ------------------------------------------------------------------
    # FFT

    def grid_to_image(self, w_slice: int):
        self.dirty = fourier.grid_to_image(
            self.grid, self.dirty, self.taper1d,
            jnp.asarray(self.mid_w[w_slice], self._rdtype),
            jnp.asarray(self.image_p.pixel_size, self._rdtype),
            pixels=self.pixels)

    # ------------------------------------------------------------------
    # normalisation / PSF

    def psf_peak(self) -> np.ndarray:
        N = self.pixels
        return np.asarray(self.dirty[:, N // 2, N // 2])

    def scale_dirty(self, scale: np.ndarray):
        self.dirty = fourier.scale_image(self.dirty,
                                         jnp.asarray(scale, self._rdtype))

    def dirty_to_psf(self):
        """Buffer swap (reference imaging.py:370)."""
        self.psf, self.dirty = self.dirty, self.psf

    def psf_patch(self):
        psf = np.asarray(self.psf)
        box = clean_ops.psf_patch(psf, self.clean_p.psf_cutoff,
                                  self.clean_p.psf_limit)
        # Cache the patch array for CLEAN.
        N = self.pixels
        y0 = N // 2 - box[1] // 2
        x0 = N // 2 - box[2] // 2
        self._psf_patch_arr = jnp.asarray(
            psf[:, y0:y0 + box[1], x0:x0 + box[2]])
        return box

    def extract_psf_core(self, patch) -> np.ndarray:
        """Central PSF region (first polarization) for beam fitting."""
        psf = np.asarray(self.psf)
        y0 = (psf.shape[1] - patch[1]) // 2
        x0 = (psf.shape[2] - patch[2]) // 2
        return psf[0, y0:y0 + patch[1], x0:x0 + patch[2]]

    # ------------------------------------------------------------------
    # CLEAN

    def noise_est(self) -> float:
        border = round(self.clean_p.border * self.pixels)
        return float(clean_ops.noise_est(self.dirty, border_pixels=border))

    def clean_reset(self):
        box = self._psf_patch_arr.shape
        cfg = clean_ops.CleanConfig(
            pixels=self.pixels, num_pols=self.num_pols,
            border_pixels=round(self.clean_p.border * self.pixels),
            patch_y=int(box[1]), patch_x=int(box[2]),
            mode=self.clean_p.mode, loop_gain=self.clean_p.loop_gain)
        self._clean_cfg = cfg
        self._clean_state = clean_ops.make_state(cfg, self.dirty, self.model)

    def clean_cycles(self, threshold: float, max_cycles: int):
        """Run up to ``max_cycles`` minor cycles on device; returns
        (cycles_done, first_peak_metric, last_peak_metric)."""
        self._clean_state, k, first, last = clean_ops.minor_cycles(
            self._clean_cfg, self._clean_state, self._psf_patch_arr,
            jnp.asarray(threshold, self._rdtype), max_cycles)
        return int(k), float(first), float(last)

    def clean_finish(self):
        """Copy CLEAN results back to the dirty/model buffers."""
        self.dirty = clean_ops.residual_image(self._clean_cfg, self._clean_state)
        self.model = self._clean_state.model

    # ------------------------------------------------------------------
    # finishing

    def set_beam_power(self, beam_power: np.ndarray):
        self.beam_power = jnp.asarray(beam_power, self._rdtype)

    def apply_primary_beam(self, cutoff: float):
        self.dirty = fourier.apply_primary_beam(
            self.dirty, self.beam_power, cutoff, jnp.nan)
        self.model = fourier.apply_primary_beam(
            self.model, self.beam_power, cutoff, 0.0)

    def convolve_model_with_beam(self, restoring_beam: beam_ops.Beam):
        self.model = beam_ops.convolve_beam(self.model, restoring_beam)

    def add_model_to_dirty(self):
        self.dirty = fourier.add_image(self.dirty, self.model)

    # buffer access (parity with reference get_buffer)
    def get_buffer(self, name: str) -> np.ndarray:
        if name == "weights_grid":
            return np.asarray(self.weights.grid)
        return np.asarray(getattr(self, name))
