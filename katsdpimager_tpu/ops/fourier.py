r"""Grid <-> image transforms: FFT plus fused taper / n / W-phase corrections.

Replaces the reference's cuFFT plans plus ``layer_to_image.mako`` /
``image_to_layer.mako`` kernels (``image.py``) with XLA FFTs and fused
elementwise math.  The measurement equation convention is

.. math:: V(u, v, w) = \int \frac{I(l, m)}{n} e^{-2\pi i(ul + vm + w(n-1))}\,dl\,dm

(reference image.py:55-63).  ``grid_to_image`` therefore:

- inverse-FFTs the (fftshifted) grid, unnormalized to match the reference's
  cuFFT scaling (image.py:787-789);
- multiplies by the per-slice W correction :math:`e^{2\pi i w(n-1)}` and
  keeps the real part;
- multiplies by :math:`n = \sqrt{1 - l^2 - m^2}` and divides by the
  separable anti-aliasing taper;
- accumulates into the W-stacked image.

``image_to_grid`` divides by taper and ``n`` (division in both directions is
deliberate: the taper transform is convolved in on both paths, reference
image.py:39-43) and applies the conjugate W phase.

All elementwise factors are fused by XLA into the FFT's neighbourhood.
The fftshifts are eliminated algebraically: for even N a half-period
shift on either side of a DFT is a Nyquist modulation, so both the input
ifftshift and the output fftshift fold into (-1)^(x+y) checkerboards that
fuse into the elementwise chains (zero memory passes) — see
``_checkerboard``.  The transform itself is XLA's FFT (cuFFT on the GPU,
the reference's own choice); ``KTPU_FFT=mxu`` selects the four-step
matmul FFT of :mod:`.fft` instead.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import fft as mfft


def _lm_grids(pixels: int, pixel_size, dtype):
    """(n, n - 1) with n = sqrt(1 - l^2 - m^2) over the *centred* image
    layout.

    lm(x) = lm_scale * x + lm_bias with lm_scale = pixel_size and
    lm_bias = -pixels/2 * pixel_size (reference imaging.py:90-91).
    ``n - 1`` is evaluated as ``-(l^2 + m^2) / (1 + n)``: subtracting 1
    from n cancels all but a few of float32's digits near the phase
    centre, and the W phase 2 pi w (n - 1) multiplies that error by w.
    """
    pixel_size = jnp.asarray(pixel_size, dtype)
    lm = (jnp.arange(pixels, dtype=dtype) * pixel_size
          - 0.5 * pixels * pixel_size)
    lm2 = lm * lm
    r2 = lm2[:, None] + lm2[None, :]
    n = jnp.sqrt(1.0 - r2)
    return n, -r2 / (1.0 + n)


def _checkerboard(pixels: int, dtype):
    """(-1)^(x+y) over an (N, N) array (N even).

    A half-period circular shift on either side of a DFT equals a Nyquist
    modulation on the other, so ifftshift-before plus fftshift-after an
    (i)fft2 reduce to this checkerboard applied to input and output —
    both fuse into adjacent elementwise chains, eliminating the two
    multi-MB roll passes the explicit shifts cost.
    """
    s = jnp.where(jnp.arange(pixels) % 2 == 0,
                  jnp.asarray(1, dtype), jnp.asarray(-1, dtype))
    return s[:, None] * s[None, :]


def _ifft2(x):
    if mfft.use_mxu_fft():
        return mfft.ifft2(x)
    return jnp.fft.ifft2(x, axes=(-2, -1))


def _fft2(x):
    if mfft.use_mxu_fft():
        return mfft.fft2(x)
    return jnp.fft.fft2(x, axes=(-2, -1))


def grid_to_image_impl(grid, image, kernel1d, w, pixel_size, *, pixels: int):
    """IFFT the grid and accumulate the W-corrected layer into ``image``.

    grid: (P, N, N) complex, centred; image: (P, N, N) real (donated,
    accumulated); kernel1d: (N,) taper samples; w: scalar mid-w of the
    slice in wavelengths.  Shift-free formulation: with
    M = ifft2(grid * cb) and cb the checkerboard,
    out = image + M.re * A + M.im * B where
    A = cb * cos(phase) * n * N^2 / taper2 and B = -cb * sin(phase) ...
    — algebraically identical to
    fftshift(elementwise(ifft2(ifftshift(grid)))) for even N.
    """
    rdtype = image.dtype
    cb = _checkerboard(pixels, rdtype)
    layer = _ifft2(grid * cb)
    scale = pixels * pixels  # match unnormalized cuFFT inverse
    n, nm1 = _lm_grids(pixels, pixel_size, rdtype)
    phase = (2 * jnp.pi) * w * nm1
    taper2 = jnp.outer(kernel1d, kernel1d).astype(rdtype)
    common = cb * (n * scale) / taper2
    a = jnp.cos(phase) * common
    b = -jnp.sin(phase) * common
    return image + (layer.real * a + layer.imag * b).astype(rdtype)


#: Jitted single-channel entry point (image buffer donated).
grid_to_image = partial(jax.jit, static_argnames=("pixels",),
                        donate_argnums=(1,))(grid_to_image_impl)


def grid_to_image_parts_impl(gr, gi, image, kernel1d, w, pixel_size, *,
                             pixels: int):
    """:func:`grid_to_image_impl` taking the grid as (P, N, N) f32 re/im
    planes."""
    return grid_to_image_impl(jax.lax.complex(gr, gi), image, kernel1d,
                              w, pixel_size, pixels=pixels)


def image_to_grid_parts_impl(image, kernel1d, w, pixel_size, *,
                             pixels: int):
    """:func:`image_to_grid_impl` returning (P, N, N) f32 re/im
    planes."""
    g = image_to_grid_impl(image, kernel1d, w, pixel_size, pixels=pixels)
    return (jnp.real(g).astype(jnp.float32),
            jnp.imag(g).astype(jnp.float32))


def grid_to_image_batched_impl(grids, image, kernel1d, ws, pixel_size, *,
                               pixels: int):
    """W-stacked accumulation with ALL slices transformed in one batch.

    grids: (S, P, N, N) complex, centred; ws: (S,) mid-w per slice.
    Equivalent to scanning :func:`grid_to_image_impl` over slices, but
    the S*P transforms run as one batched FFT with one fusion
    neighbourhood for the corrections.  Costs S grids of device memory
    instead of one.
    """
    rdtype = image.dtype
    cb = _checkerboard(pixels, rdtype)
    layer = _ifft2(grids * cb)
    scale = pixels * pixels
    n, nm1 = _lm_grids(pixels, pixel_size, rdtype)
    phase = (2 * jnp.pi) * ws[:, None, None, None] * nm1[None, None]
    taper2 = jnp.outer(kernel1d, kernel1d).astype(rdtype)
    common = (cb * (n * scale) / taper2)[None, None]
    acc = jnp.sum(layer.real * (jnp.cos(phase) * common)
                  + layer.imag * (-jnp.sin(phase) * common), axis=0)
    return image + acc.astype(rdtype)


def image_to_grid_impl(image, kernel1d, w, pixel_size, *, pixels: int):
    """Forward transform of ``grid_to_image`` (for degridding prediction).

    Returns the (P, N, N) complex grid with centre at the middle.  Same
    shift-free checkerboard formulation as :func:`grid_to_image_impl`.
    """
    rdtype = image.dtype
    cb = _checkerboard(pixels, rdtype)
    n, nm1 = _lm_grids(pixels, pixel_size, rdtype)
    taper2 = jnp.outer(kernel1d, kernel1d).astype(rdtype)
    phase = (-2 * jnp.pi) * w * nm1
    pre = cb / (taper2 * n)
    layer = (image * pre) * (jnp.cos(phase) + 1j * jnp.sin(phase))
    return _fft2(layer) * _checkerboard(pixels, jnp.real(layer).dtype)


#: Jitted single-channel entry point.
image_to_grid = partial(jax.jit, static_argnames=("pixels",))(image_to_grid_impl)


@jax.jit
def scale_image(image, scale):
    """Per-polarization scalar multiply (reference scale.mako)."""
    return image * scale[:, None, None]


@jax.jit
def add_image(dest, src):
    return dest + src


@jax.jit
def apply_primary_beam(image, beam_power, cutoff, replacement):
    """Divide by the primary-beam power, replacing pixels below ``cutoff``
    (NaN for sky images, 0 for model images; reference
    apply_primary_beam.mako / image.py:497)."""
    return jnp.where(beam_power[None] >= cutoff, image / beam_power[None],
                     replacement)


def grid_to_image_reference(grid, image, kernel1d, w, pixel_size):
    """Numpy oracle mirroring reference GridToImageHost (image.py:743-800)."""
    import numpy as np

    pixels = image.shape[-1]
    layer = np.fft.ifft2(np.fft.ifftshift(grid, axes=(-2, -1)), axes=(-2, -1))
    scale = pixels * pixels
    lm = np.arange(pixels) * pixel_size - 0.5 * pixels * pixel_size
    lm = np.fft.ifftshift(lm)
    lm2 = lm * lm
    n = np.sqrt(1 - (lm2[:, None] + lm2[None, :]))
    layer = layer * np.exp(2j * np.pi * w * (n - 1))
    out = layer.real * scale * n[None]
    out = np.fft.fftshift(out, axes=(-2, -1))
    out = out / np.outer(kernel1d, kernel1d)[None]
    return image + out
