r"""CLEAN deconvolution: tile-accelerated minor cycles, fully on device.

Algorithm parity with the reference ``clean.py``: the image interior (inside
a ``border`` margin) is divided into 32x32 tiles; per-tile peak value and
position are cached; a minor cycle finds the best tile, subtracts
``loop_gain * peak`` times the PSF patch, records the component in the model
and refreshes only the touched tiles.  The peak metric is either Stokes-I
absolute value (:data:`CLEAN_I`) or the sum of squares over polarizations
(:data:`CLEAN_SUMSQ`).

Architecture difference from the reference: the reference's GPU
implementation round-trips to the host on *every* minor cycle to test the
threshold (clean.py:10-13, its known bottleneck).  Here the whole minor-cycle
loop is a ``lax.while_loop`` on device: peak-find is an argmax over the tile
cache, PSF subtraction is a dynamic-slice update on a zero-padded residual
(padding replaces the reference's edge clipping), and the threshold test is
on-device.  One host sync happens per *batch* of minor cycles.

State is a :class:`CleanState` pytree; geometry is a static
:class:`CleanConfig` so each (pixels, patch, border) combination compiles
once.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats

#: Use only Stokes I to find peaks
CLEAN_I = 0
#: Use the sum of squares of available Stokes components
CLEAN_SUMSQ = 1

#: Scales median absolute value of a zero-mean Gaussian to its standard
#: deviation: 1 / sqrt(chi2.ppf(0.5, 1)).
_MEDIAN_TO_RMS = 1.4826022185056031

_TILE = 32


def metric_to_power(mode: int, metric):
    """Convert peak metric to a linear power scale (Jy/beam)."""
    return math.sqrt(metric) if mode == CLEAN_SUMSQ else metric


def power_to_metric(mode: int, power):
    return power * power if mode == CLEAN_SUMSQ else power


def noise_threshold_scale(mode: int, threshold: float, num_polarizations: int) -> float:
    """Scale a Gaussian sigma threshold for the CLEAN_SUMSQ chi-squared
    metric (reference clean.py:187-204)."""
    if mode == CLEAN_I:
        return threshold
    p = 2 * scipy.stats.norm.sf(threshold)
    return float(np.sqrt(scipy.stats.chi2.isf(p, num_polarizations)))


def psf_patch(psf: np.ndarray, threshold: float, limit: float | None = None):
    """Bounding box of |psf| >= threshold, centred, odd-sized, optionally
    capped at ``limit`` of the image (reference clean.py:894-936)."""
    if limit is not None:
        hlimit = (round(limit * min(psf.shape[1], psf.shape[2])) - 1) // 2
        mid_x = psf.shape[2] // 2
        mid_y = psf.shape[1] // 2
        min_x = max(0, mid_x - hlimit)
        min_y = max(0, mid_y - hlimit)
        max_x = min(psf.shape[2] - 1, mid_x + hlimit)
        max_y = min(psf.shape[1] - 1, mid_y + hlimit)
        psf = psf[:, min_y:max_y + 1, min_x:max_x + 1]
    nz = np.nonzero(np.abs(psf) >= threshold)
    if len(nz[0]) == 0:
        return (psf.shape[0], 1, 1)
    y_dist = int(np.max(np.abs(nz[1] - psf.shape[1] // 2)))
    x_dist = int(np.max(np.abs(nz[2] - psf.shape[2] // 2)))
    return (psf.shape[0],
            min(psf.shape[1], 2 * y_dist + 1),
            min(psf.shape[2], 2 * x_dist + 1))


def _order_stats_bits(bits, k1, k2):
    """Bit patterns of the k1-th and k2-th smallest non-negative floats.

    Non-negative IEEE floats order identically to their int bit patterns,
    so the exact order statistic is found by a 31-step MSB-to-LSB binary
    search over bit prefixes, each step one rank count over the data —
    the reference's GPU median algorithm (clean.py:295-353), and ~10x
    faster than a sort-based median for large images."""
    def body(i, prefixes):
        b = 30 - i
        p1, p2 = prefixes
        t1 = p1 | (1 << b)
        t2 = p2 | (1 << b)
        c1 = jnp.sum((bits < t1).astype(jnp.int32), dtype=jnp.int32)
        c2 = jnp.sum((bits < t2).astype(jnp.int32), dtype=jnp.int32)
        return (jnp.where(c1 <= k1, t1, p1), jnp.where(c2 <= k2, t2, p2))

    zero = jnp.zeros((), jnp.int32)
    return jax.lax.fori_loop(0, 31, body, (zero, zero))


@partial(jax.jit, static_argnames=("border_pixels",))
def noise_est(image, *, border_pixels: int):
    """Robust noise estimate: scaled median absolute value of the interior
    (reference clean.py:938-943; exact median via rank binary search)."""
    interior = image[:, border_pixels:image.shape[1] - border_pixels,
                     border_pixels:image.shape[2] - border_pixels]
    a = jnp.abs(interior).ravel()
    n = a.size
    bits = jax.lax.bitcast_convert_type(a.astype(jnp.float32), jnp.int32)
    b1, b2 = _order_stats_bits(bits, (n - 1) // 2, n // 2)
    v1 = jax.lax.bitcast_convert_type(b1, jnp.float32)
    v2 = jax.lax.bitcast_convert_type(b2, jnp.float32)
    median = 0.5 * (v1 + v2)
    return median.astype(interior.dtype) * _MEDIAN_TO_RMS


@dataclasses.dataclass(frozen=True)
class CleanConfig:
    """Static CLEAN geometry (hashable; used as a jit static argument)."""

    pixels: int
    num_pols: int
    border_pixels: int
    patch_y: int
    patch_x: int
    mode: int
    loop_gain: float

    @property
    def interior(self) -> int:
        return self.pixels - 2 * self.border_pixels

    @property
    def tiles(self) -> int:
        return -(-self.interior // _TILE)

    @property
    def pad(self) -> int:
        # Padding must absorb both the PSF window overhang at image edges
        # and the tile grid's overhang past the interior (ragged last tile).
        return max(max(self.patch_y, self.patch_x) // 2 + 1, _TILE)

    @property
    def window_tiles_y(self) -> int:
        return min((self.patch_y - 1) // _TILE + 2, self.tiles)

    @property
    def window_tiles_x(self) -> int:
        return min((self.patch_x - 1) // _TILE + 2, self.tiles)


class CleanState(NamedTuple):
    """Device-resident CLEAN state."""

    residual: jnp.ndarray   # (P, N + 2*pad, N + 2*pad), zero-padded
    model: jnp.ndarray      # (P, N, N)
    tile_max: jnp.ndarray   # (T, T) peak metric per tile
    tile_pos: jnp.ndarray   # (T, T, 2) absolute (y, x) of each tile's peak


def _metric(cfg: CleanConfig, window):
    """Peak metric of a residual window (P, h, w) -> (h, w)."""
    if cfg.mode == CLEAN_I:
        return jnp.abs(window[0])
    return jnp.sum(window * window, axis=0)


def _tile_scan(cfg: CleanConfig, residual, t0y, t0x, nty: int, ntx: int):
    """Recompute tile peaks for an (nty x ntx)-tile window anchored at tile
    (t0y, t0x).  Returns (win_max (nty,ntx), win_pos (nty,ntx,2))."""
    pad = cfg.pad
    b = cfg.border_pixels
    base_y = jnp.asarray(b + pad + t0y * _TILE, jnp.int32)
    base_x = jnp.asarray(b + pad + t0x * _TILE, jnp.int32)
    window = jax.lax.dynamic_slice(
        residual, (jnp.zeros((), jnp.int32), base_y, base_x),
        (cfg.num_pols, nty * _TILE, ntx * _TILE))
    metric = _metric(cfg, window)
    # Mask positions outside the interior (ragged last tile / padding).
    iy = t0y * _TILE + jax.lax.broadcasted_iota(jnp.int32, metric.shape, 0)
    ix = t0x * _TILE + jax.lax.broadcasted_iota(jnp.int32, metric.shape, 1)
    metric = jnp.where((iy < cfg.interior) & (ix < cfg.interior), metric, -1.0)

    m = metric.reshape(nty, _TILE, ntx, _TILE).transpose(0, 2, 1, 3)
    m = m.reshape(nty, ntx, _TILE * _TILE)
    win_max = jnp.max(m, axis=-1)
    idx = jnp.argmax(m, axis=-1).astype(jnp.int32)
    dy = idx // _TILE
    dx = idx % _TILE
    ty = jax.lax.broadcasted_iota(jnp.int32, (nty, ntx), 0)
    tx = jax.lax.broadcasted_iota(jnp.int32, (nty, ntx), 1)
    pos_y = b + (t0y + ty) * _TILE + dy
    pos_x = b + (t0x + tx) * _TILE + dx
    return win_max, jnp.stack([pos_y, pos_x], axis=-1)


def make_state(cfg: CleanConfig, residual, model) -> CleanState:
    """Build device state from a dirty/residual image and model."""
    pad = cfg.pad
    res_pad = jnp.pad(jnp.asarray(residual),
                      ((0, 0), (pad, pad), (pad, pad)))
    T = cfg.tiles
    tile_max = jnp.zeros((T, T), residual.dtype)
    tile_pos = jnp.zeros((T, T, 2), jnp.int32)
    state = CleanState(res_pad, jnp.asarray(model), tile_max, tile_pos)
    return reset(cfg, state)


@partial(jax.jit, static_argnames=("cfg",))
def reset(cfg: CleanConfig, state: CleanState) -> CleanState:
    """Recompute the whole tile cache (after the residual changed)."""
    T = cfg.tiles
    win_max, win_pos = _tile_scan(cfg, state.residual, 0, 0, T, T)
    return state._replace(tile_max=win_max, tile_pos=win_pos)


def residual_image(cfg: CleanConfig, state: CleanState):
    pad = cfg.pad
    return state.residual[:, pad:pad + cfg.pixels, pad:pad + cfg.pixels]


def minor_cycles_impl(cfg: CleanConfig, state: CleanState, psf_patch_arr,
                      threshold, max_cycles: int):
    """Run up to ``max_cycles`` minor cycles on device.

    Stops (without subtracting) when the peak metric drops below
    ``threshold``.  Returns ``(state, cycles_done, first_peak, last_peak)``
    where ``first_peak`` is the metric before any subtraction this batch
    (used for the major-gain threshold) and ``last_peak`` the metric that
    stopped the loop (or the final peak examined).
    """
    T = cfg.tiles
    ph, pw = cfg.patch_y, cfg.patch_x
    pad = cfg.pad
    nty, ntx = cfg.window_tiles_y, cfg.window_tiles_x

    def find_peak(st):
        flat = jnp.argmax(st.tile_max)
        ty, tx = flat // T, flat % T
        return st.tile_max[ty, tx], st.tile_pos[ty, tx]

    def subtract(st, pos):
        py, px = pos[0], pos[1]
        scale = cfg.loop_gain * st.residual[:, py + pad, px + pad]
        y0 = py + pad - ph // 2
        x0 = px + pad - pw // 2
        zero = jnp.zeros((), y0.dtype)
        window = jax.lax.dynamic_slice(st.residual, (zero, y0, x0),
                                       (cfg.num_pols, ph, pw))
        window = window - scale[:, None, None] * psf_patch_arr
        residual = jax.lax.dynamic_update_slice(st.residual, window,
                                                (zero, y0, x0))
        model = st.model.at[:, py, px].add(scale)
        # Refresh the tile window covering the subtraction footprint.
        t0y = jnp.clip((py - cfg.border_pixels - ph // 2) // _TILE, 0, T - nty)
        t0x = jnp.clip((px - cfg.border_pixels - pw // 2) // _TILE, 0, T - ntx)
        win_max, win_pos = _tile_scan(cfg, residual, t0y, t0x, nty, ntx)
        tile_max = jax.lax.dynamic_update_slice(st.tile_max, win_max, (t0y, t0x))
        tile_pos = jax.lax.dynamic_update_slice(
            st.tile_pos, win_pos, (t0y, t0x, jnp.zeros((), t0y.dtype)))
        return CleanState(residual, model, tile_max, tile_pos)

    def body(carry):
        st, k, first_peak, _last, _stop = carry
        peak, pos = find_peak(st)
        first_peak = jnp.where(k == 0, peak, first_peak)
        go = peak >= threshold
        st = jax.lax.cond(go, lambda s: subtract(s, pos), lambda s: s, st)
        return st, k + go.astype(jnp.int32), first_peak, peak, ~go

    def cond(carry):
        _st, k, _first, _last, stop = carry
        return (~stop) & (k < max_cycles)

    zero = jnp.zeros((), state.tile_max.dtype)
    state, k, first_peak, last_peak, _ = jax.lax.while_loop(
        cond, body, (state, jnp.int32(0), zero, zero, jnp.bool_(False)))
    return state, k, first_peak, last_peak


#: Jitted single-channel entry point.
minor_cycles = partial(jax.jit,
                       static_argnames=("cfg", "max_cycles"))(minor_cycles_impl)
