r"""Convolutional gridding and degridding (XLA formulation).

The reference grids with a Romein-style CUDA scatter kernel using atomic
float adds (``grid.mako``, ``grid.py:5-116``).  This module is the same
scatter written as XLA scatter-adds (on the GPU XLA lowers the adds of
duplicate indices to atomics; on the CPU they run in order):

- For each kernel tap row ``j`` (static loop of ``kernel_width``), all
  visibilities scatter a contiguous ``kernel_width``-wide row of weighted
  kernel values into the grid with one ``.at[].add`` — i.e. ``kernel_width``
  scatters of ``N * kernel_width`` elements instead of ``N * kernel_width^2``
  scalar atomics.  Rows are contiguous in the lane dimension, which keeps the
  scatter vectorized.
- Degridding is the transposed gather: rows are gathered and contracted
  against the separable kernel taps.

Numerical conventions match the reference host gridder (``grid.py:1032-1060``):

- ``uv`` is centred (0 = grid centre); the first grid index of the kernel
  footprint is ``uv - uv_bias`` with ``uv_bias = (K-1)//2 - pixels//2``;
- gridding multiplies by the *conjugate* of the separable kernel value
  ``kernel[w_plane, sub_v, j] * kernel[w_plane, sub_u, k]``; degridding uses
  the unconjugated value;
- the imaging (density) weight is looked up at the visibility's cell
  ``(uv + pixels//2)`` and multiplied into the visibility before gridding;
  degridding subtracts ``weights * predicted`` from the stored visibilities.

:mod:`.mxu_gridder` is the fast path; this module is the correctness
baseline (and, run in float64, the oracle the accuracy checks use).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def grid_vis_impl(grid, kernel, weights_grid, uv, sub_uv, w_plane, vis, *, pixels: int):
    """Accumulate visibilities onto the UV grid.

    Parameters
    ----------
    grid : (P, pixels, pixels) complex
        Accumulation grid (donated; returned updated).
    kernel : (w_planes, oversample, K) complex64
        Tabulated separable convolution kernels.
    weights_grid : (P, pixels, pixels) float32
        Imaging-density weights.
    uv, sub_uv : (N, 2) int
        Quantized coordinates (centred).
    w_plane : (N,) int
    vis : (N, P) complex64
        Statistically-weighted visibilities.  Padding entries must be zero.
    """
    K = kernel.shape[-1]
    half = pixels // 2
    uv_bias = (K - 1) // 2 - half

    u0 = uv[:, 0].astype(jnp.int32) - uv_bias
    v0 = uv[:, 1].astype(jnp.int32) - uv_bias
    wp = w_plane.astype(jnp.int32)
    ku = kernel[wp, sub_uv[:, 0].astype(jnp.int32), :]  # (N, K)
    kv = kernel[wp, sub_uv[:, 1].astype(jnp.int32), :]  # (N, K)

    uq = (uv[:, 0].astype(jnp.int32) + half)
    vq = (uv[:, 1].astype(jnp.int32) + half)
    sample = vis.T * weights_grid[:, vq, uq]  # (P, N)

    cols = u0[:, None] + jnp.arange(K)[None, :]  # (N, K)
    ku_conj = jnp.conj(ku)

    def body(j, g):
        # All vis scatter one contiguous row of the kernel footprint.
        vals = (sample[:, :, None] * jnp.conj(kv[:, j])[None, :, None]
                * ku_conj[None, :, :])  # (P, N, K)
        return g.at[:, (v0 + j)[:, None], cols].add(vals, mode="drop")

    return jax.lax.fori_loop(0, K, body, grid, unroll=False)


#: Jitted single-channel entry point (grid buffer donated).
grid_vis = partial(jax.jit, static_argnames=("pixels",),
                   donate_argnums=(0,))(grid_vis_impl)


def degrid_vis_impl(grid, kernel, uv, sub_uv, w_plane, weights, vis, *, pixels: int):
    """Predict visibilities from the grid and subtract in place.

    ``vis`` (donated) is updated to ``vis - weights * predicted``; padding
    entries (zero weights) are unaffected.
    """
    K = kernel.shape[-1]
    half = pixels // 2
    uv_bias = (K - 1) // 2 - half

    u0 = uv[:, 0].astype(jnp.int32) - uv_bias
    v0 = uv[:, 1].astype(jnp.int32) - uv_bias
    wp = w_plane.astype(jnp.int32)
    ku = kernel[wp, sub_uv[:, 0].astype(jnp.int32), :]  # (N, K)
    kv = kernel[wp, sub_uv[:, 1].astype(jnp.int32), :]  # (N, K)
    cols = u0[:, None] + jnp.arange(K)[None, :]  # (N, K)

    def body(j, acc):
        rows = grid[:, (v0 + j)[:, None], cols]  # (P, N, K)
        return acc + jnp.einsum("pnk,nk->np", rows, ku) * kv[:, j][:, None]

    P = vis.shape[1]
    predicted = jax.lax.fori_loop(
        0, K, body, jnp.zeros((vis.shape[0], P), grid.dtype), unroll=False
    )
    return vis - weights * predicted.astype(vis.dtype)


#: Jitted single-channel entry point (vis buffer donated).
degrid_vis = partial(jax.jit, static_argnames=("pixels",),
                     donate_argnums=(6,))(degrid_vis_impl)


def grid_vis_reference(grid, kernel, weights_grid, uv, sub_uv, w_plane, vis):
    """Slow numpy oracle used by the tests (mirrors reference
    grid.py:1032-1054 semantics)."""
    import numpy as np

    K = kernel.shape[-1]
    pixels = grid.shape[-1]
    uv_bias = (K - 1) // 2 - pixels // 2
    for row in range(len(uv)):
        u0 = int(uv[row, 0]) - uv_bias
        v0 = int(uv[row, 1]) - uv_bias
        sub_u, sub_v = int(sub_uv[row, 0]), int(sub_uv[row, 1])
        uq = int(uv[row, 0]) + pixels // 2
        vq = int(uv[row, 1]) + pixels // 2
        sample = vis[row] * weights_grid[:, vq, uq]
        for j in range(K):
            for k in range(K):
                ks = kernel[w_plane[row], sub_v, j] * kernel[w_plane[row], sub_u, k]
                grid[:, v0 + j, u0 + k] += sample * np.conj(ks)
    return grid


def degrid_vis_reference(grid, kernel, uv, sub_uv, w_plane, weights, vis):
    """Slow numpy oracle (mirrors reference grid.py:1138-1155)."""
    import numpy as np

    K = kernel.shape[-1]
    pixels = grid.shape[-1]
    uv_bias = (K - 1) // 2 - pixels // 2
    out = vis.copy()
    for row in range(len(uv)):
        u0 = int(uv[row, 0]) - uv_bias
        v0 = int(uv[row, 1]) - uv_bias
        sub_u, sub_v = int(sub_uv[row, 0]), int(sub_uv[row, 1])
        sample = np.zeros(vis.shape[1], grid.dtype)
        for j in range(K):
            for k in range(K):
                wgt = kernel[w_plane[row], sub_v, j] * kernel[w_plane[row], sub_u, k]
                sample += wgt * grid[:, v0 + j, u0 + k]
        out[row] -= weights[row] * sample
    return out
