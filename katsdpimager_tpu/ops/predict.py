r"""Direct prediction: DFT of point-source components, subtracted in place.

The reference implements this as a CUDA kernel looping sources in shared
memory per visibility (``predict.mako``, ``predict.py``).  Here the
computation is two matmuls: the phase matrix is a (N_vis x 3) @
(3 x N_src) product, and the flux accumulation another, evaluated in
visibility blocks so nothing large is materialised.

Conventions (parity with reference ``predict.py:122-150,419-439``):

- quantized UV is dequantized at bin centres:
  ``uv_wl = (uv * oversample + sub_uv + 0.5) * cell / (oversample * lambda)``;
- w is dequantized per plane and offset by the W-slice mid-w;
- the predicted visibility is ``sum_s flux[s] * exp(-2 pi i (u l + v m +
  w (n-1)))`` and ``weights * predicted`` is subtracted from the stored
  (pre-weighted) visibilities;
- fluxes are tapered by ``sinc(l / (image_size * oversample))`` per axis to
  mirror the quantisation of the UV coordinates (predict.py:53-64).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def uvw_scale_bias(image_parameters, grid_parameters):
    """(uv_scale, w_scale, w_bias) in wavelengths for dequantization."""
    ip, gp = image_parameters, grid_parameters
    uv_scale = ip.cell_size / gp.fixed.oversample / ip.wavelength
    w_scale = gp.fixed.max_w / ((gp.w_slices - 0.5) * gp.w_planes) / ip.wavelength
    w_bias = (0.5 - 0.5 * gp.w_planes) * w_scale
    return float(uv_scale), float(w_scale), float(w_bias)


def extract_sky_image(image_parameters, grid_parameters, model_image: np.ndarray,
                      return_pixels: bool = False):
    """Convert non-zero model-image pixels into (lmn, flux) component lists
    (reference predict.py:73-119, without the dict indirection).

    Returns (lmn (S, 3) float32 with n-1 in the last column, flux (S, P));
    with ``return_pixels`` also the centre-relative integer pixel indices
    (xi, yi) that :func:`predict_subtract_exact` consumes.
    """
    ip = image_parameters
    mask = np.any(model_image != 0, axis=0)
    ys, xs = np.nonzero(mask)
    pixel_size = float(ip.pixel_size)
    l = (xs - 0.5 * ip.pixels) * pixel_size
    m = (ys - 0.5 * ip.pixels) * pixel_size
    n1 = np.sqrt(1.0 - (np.square(l) + np.square(m))) - 1.0
    lmn = np.stack([l, m, n1], axis=-1).astype(np.float32)
    flux = model_image[:, ys, xs].T.astype(np.float64)
    taper_scale = float(ip.image_size * grid_parameters.fixed.oversample)
    taper = np.sinc(l / taper_scale) * np.sinc(m / taper_scale)
    flux = (flux * taper[:, None]).astype(model_image.dtype)
    if return_pixels:
        xi = (xs - ip.pixels // 2).astype(np.int32)
        yi = (ys - ip.pixels // 2).astype(np.int32)
        return lmn, flux, xi, yi
    return lmn, flux


@partial(jax.jit, static_argnames=("oversample", "block"), donate_argnums=(5,))
def predict_subtract(lmn, flux, uv, sub_uv, w_plane, vis, weights,
                     uv_scale, w_scale, w_bias, *, oversample: int,
                     block: int = 8192):
    """Subtract the DFT of (lmn, flux) from the stored visibilities.

    lmn: (S, 3) float32 (l, m, n-1); flux: (S, P) real;
    vis: (N, P) complex64 (donated); weights: (N, P) float32.
    ``w_bias`` must already include the W-slice mid-w.  N must be a
    multiple of ``block`` or smaller than it (pad with zero weights);
    blocking bounds the (block, S) phase matrix.
    """
    u = (uv[:, 0].astype(jnp.float32) * oversample
         + sub_uv[:, 0].astype(jnp.float32) + 0.5) * uv_scale
    v = (uv[:, 1].astype(jnp.float32) * oversample
         + sub_uv[:, 1].astype(jnp.float32) + 0.5) * uv_scale
    w = w_plane.astype(jnp.float32) * w_scale + w_bias
    uvw = jnp.stack([u, v, w], axis=-1)  # (N, 3)
    fluxf = flux.astype(jnp.float32)

    def block_predict(uvw_b):
        # Phase (B, S) then two real matmuls against the flux.  Highest
        # precision: TF32 phases (about three digits) shift sources.
        hp = jax.lax.Precision.HIGHEST
        phase = (-2 * jnp.pi) * jnp.matmul(uvw_b, lmn.T, precision=hp)
        re = jnp.matmul(jnp.cos(phase), fluxf, precision=hp)
        im = jnp.matmul(jnp.sin(phase), fluxf, precision=hp)
        return re + 1j * im

    N = vis.shape[0]
    if N <= block:
        predicted = block_predict(uvw)
    else:
        nb = -(-N // block)
        pad = nb * block - N
        uvw_p = jnp.pad(uvw, ((0, pad), (0, 0))).reshape(nb, block, 3)
        predicted = jax.lax.map(block_predict, uvw_p)
        predicted = predicted.reshape(nb * block, -1)[:N]
    return vis - weights * predicted.astype(vis.dtype)


@partial(jax.jit,
         static_argnames=("pixels", "oversample", "w_planes", "block"),
         donate_argnums=(6,))
def predict_subtract_exact(xi, yi, n1, flux, uv, sub_uv, vis, weights,
                           w_plane, w_scale, w_bias, *, pixels: int,
                           oversample: int, w_planes: int,
                           block: int = 8192):
    """Trig-free direct prediction for pixel-grid components.

    Model components sit on image pixels (``xi``, ``yi`` centre-relative
    ints from :func:`extract_sky_image`) and UV is subgrid-quantized, so
    every UV phase is an exact multiple of ``2*pi / (2*pixels*oversample)``
    (``cell_size = wavelength/image_size`` makes
    ``u_wl * l = (2*uq+1)*x / (2*N*O)`` an identity): the per-visibility
    phase factor is one of M = 2*N*O roots of unity, gathered from a
    table after exact int32 index arithmetic — no
    per-(vis, source) transcendentals, unlike the reference's per-pair
    ``sincospif`` (predict.mako:56-70).  The W phase takes only
    ``w_planes`` distinct values per slice, so it folds into per-plane
    flux columns: a (B,S)@(S,W*P) matmul plus a row-wise column
    pick.  Bit-compatible with :func:`predict_subtract` to f32 rounding.

    vis (donated) and weights are (N, P); returns vis - weights*predicted.
    """
    M = 2 * pixels * oversample
    ang = -2.0 * np.pi * np.arange(M) / M
    tab_re = jnp.asarray(np.cos(ang).astype(np.float32))
    tab_im = jnp.asarray(np.sin(ang).astype(np.float32))
    hp = jax.lax.Precision.HIGHEST

    P = vis.shape[1]
    wvals = jnp.arange(w_planes, dtype=jnp.float32) * w_scale + w_bias
    wphase = (-2 * jnp.pi) * wvals[:, None] * n1.astype(jnp.float32)[None, :]
    fluxf = flux.astype(jnp.float32)                       # (S, P)
    # (S, W*P) per-plane flux columns, rotated by the w phase
    fw_re = (jnp.cos(wphase)[:, :, None] * fluxf[None]).transpose(1, 0, 2)
    fw_im = (jnp.sin(wphase)[:, :, None] * fluxf[None]).transpose(1, 0, 2)
    fw_re = fw_re.reshape(-1, w_planes * P)
    fw_im = fw_im.reshape(-1, w_planes * P)

    au = (2 * (uv[:, 0].astype(jnp.int32) * oversample
               + sub_uv[:, 0].astype(jnp.int32)) + 1) % M
    av = (2 * (uv[:, 1].astype(jnp.int32) * oversample
               + sub_uv[:, 1].astype(jnp.int32)) + 1) % M
    xm = xi.astype(jnp.int32) % M
    ym = yi.astype(jnp.int32) % M

    def blk(args):
        au_b, av_b, wp_b, vis_b, wts_b = args
        k = (au_b[:, None] * xm[None, :]
             + av_b[:, None] * ym[None, :]) & (M - 1)
        c = jnp.take(tab_re, k, axis=0)
        s = jnp.take(tab_im, k, axis=0)
        re = (jnp.matmul(c, fw_re, precision=hp)
              - jnp.matmul(s, fw_im, precision=hp)).reshape(
                  -1, w_planes, P)
        im = (jnp.matmul(s, fw_re, precision=hp)
              + jnp.matmul(c, fw_im, precision=hp)).reshape(
                  -1, w_planes, P)
        idx = wp_b.astype(jnp.int32)[:, None, None]
        pre = (jnp.take_along_axis(re, idx, axis=1)
               + 1j * jnp.take_along_axis(im, idx, axis=1))[:, 0]
        return vis_b - wts_b * pre.astype(vis_b.dtype)

    N = vis.shape[0]
    if N <= block:
        return blk((au, av, w_plane, vis, weights))
    nb = -(-N // block)
    pad = nb * block - N

    def padv(a, fill=0):
        widths = ((0, pad),) + ((0, 0),) * (a.ndim - 1)
        return jnp.pad(a, widths).reshape((nb, block) + a.shape[1:])

    out = jax.lax.map(blk, (padv(au), padv(av), padv(w_plane), padv(vis),
                            padv(weights)))
    return out.reshape(nb * block, P)[:N]


def predict_subtract_reference(lmn, flux, uv, sub_uv, w_plane, vis, weights,
                               uv_scale, w_scale, w_bias, oversample):
    """Numpy oracle (mirrors reference predict.py:419-439)."""
    out = vis.copy()
    for i in range(len(uv)):
        u = (uv[i, 0] * oversample + sub_uv[i, 0] + 0.5) * uv_scale
        v = (uv[i, 1] * oversample + sub_uv[i, 1] + 0.5) * uv_scale
        w = w_plane[i] * w_scale + w_bias
        phase = lmn[:, 0] * u + lmn[:, 1] * v + lmn[:, 2] * w
        rot = np.exp(-2j * np.pi * phase)
        out[i] -= weights[i] * (rot @ flux)
    return out
