"""Matmul FFT: Bailey four-step decomposition into dense matmuls.

A length-N DFT with N = N1*N2 factors into N2-point DFTs, a twiddle
multiply, and N1-point DFTs (Bailey 1990), turning the transform into two
dense matmuls of the small DFT matrices against the reshaped signal.  The
reference relies on cuFFT (`/root/reference/katsdpimager/fft.py`), which
XLA calls on the GPU; this formulation is an alternative kept off the
default path (``KTPU_FFT=mxu``) until it is compared on the card.

Derivation (sign s = -1 forward, +1 inverse): with n = n2*N1 + n1 and
k = k1*N2 + k2,

    y[k1*N2 + k2] = sum_{n1} W_N1[k1, n1] * T[n1, k2]
                    * sum_{n2} x[n2*N1 + n1] * W_N2[n2, k2]

where W_M[a, b] = exp(s*2i*pi*a*b/M) and the twiddle
T[n1, k2] = exp(s*2i*pi*n1*k2/N).  As arrays:

    A = x.reshape(..., N2, N1).swapaxes(-1, -2)      # A[n1, n2]
    y = (W_N1 @ (A @ W_N2 * T)).reshape(..., N)

All heavy work is two (..., N1, N2)-batched matmuls with 64..128-wide
contractions; the twiddle fuses into them.  Matmul precision is
HIGHEST (f32 emulation) by default: measured dirty-image agreement with
the XLA FFT is at the f32 rounding floor (tests/test_fourier.py).

Inverse transforms fold the 1/N normalisation into W_N1.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["fft", "ifft", "fft2", "ifft2", "use_mxu_fft"]


def _split(n: int):
    """Pick N1*N2 = n with both factors at most 128, N1 >= N2."""
    if n & (n - 1) or n < 4:
        return None
    n1 = 1 << ((n.bit_length() - 1 + 1) // 2)   # ceil half of the log
    n2 = n // n1
    if n1 > 128 or n2 > 128:
        return None                              # n > 16384: not needed
    return n1, n2


def _dft_mats(n: int, sign: int, inverse_norm: bool):
    """(W_N1, W_N2, twiddle) as numpy complex64 (in-trace constants)."""
    n1, n2 = _split(n)
    a1 = np.arange(n1)
    a2 = np.arange(n2)
    w1 = np.exp(sign * 2j * np.pi / n1 * np.outer(a1, a1))
    w2 = np.exp(sign * 2j * np.pi / n2 * np.outer(a2, a2))
    tw = np.exp(sign * 2j * np.pi / n * np.outer(a1, a2))
    if inverse_norm:
        w1 = w1 / n
    return (w1.astype(np.complex64), w2.astype(np.complex64),
            tw.astype(np.complex64))


def _four_step_last(x, sign: int, inverse_norm: bool, precision):
    """Length-N transform along the last axis via two matmuls."""
    n = x.shape[-1]
    n1, n2 = _split(n)
    w1, w2, tw = _dft_mats(n, sign, inverse_norm)
    a = x.reshape(x.shape[:-1] + (n2, n1))
    a = jnp.swapaxes(a, -1, -2)                  # (..., n1, n2)
    b = jnp.matmul(a, jnp.asarray(w2), precision=precision)
    b = b * jnp.asarray(tw)
    y = jnp.matmul(jnp.asarray(w1), b, precision=precision)
    return y.reshape(x.shape)


def _supported(x, axis: int) -> bool:
    return (x.shape[axis] >= 256 and _split(x.shape[axis]) is not None
            and jnp.issubdtype(x.dtype, jnp.complexfloating))


def fft(x, axis=-1, precision=jax.lax.Precision.HIGHEST):
    """1-D complex FFT along ``axis`` (unnormalised, like jnp.fft.fft)."""
    if not _supported(x, axis):
        return jnp.fft.fft(x, axis=axis)
    x = jnp.moveaxis(x, axis, -1)
    y = _four_step_last(x, -1, False, precision)
    return jnp.moveaxis(y, -1, axis)


def ifft(x, axis=-1, precision=jax.lax.Precision.HIGHEST):
    """1-D complex inverse FFT along ``axis`` (1/N-normalised)."""
    if not _supported(x, axis):
        return jnp.fft.ifft(x, axis=axis)
    x = jnp.moveaxis(x, axis, -1)
    y = _four_step_last(x, +1, True, precision)
    return jnp.moveaxis(y, -1, axis)


def fft2(x, precision=jax.lax.Precision.HIGHEST):
    """2-D complex FFT over the last two axes."""
    return fft(fft(x, axis=-1, precision=precision), axis=-2,
               precision=precision)


def ifft2(x, precision=jax.lax.Precision.HIGHEST):
    """2-D complex inverse FFT over the last two axes."""
    return ifft(ifft(x, axis=-1, precision=precision), axis=-2,
                precision=precision)


def use_mxu_fft() -> bool:
    """Route the imaging FFTs through the four-step matmul FFT
    (``KTPU_FFT=mxu``; off by default, where XLA's FFT runs)."""
    return os.environ.get("KTPU_FFT", "").lower() == "mxu"


#: jitted helpers for benchmarking
fft2_jit = partial(jax.jit, static_argnames=("precision",))(fft2)
ifft2_jit = partial(jax.jit, static_argnames=("precision",))(ifft2)
