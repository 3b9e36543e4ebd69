r"""Matmul gridding/degridding: bucketed dense-matmul formulation.

The reference grids with a Romein-style CUDA scatter (``grid.mako``):
per-thread register accumulators flushed by atomic adds.  This module
instead restructures convolutional gridding so the :math:`K^2` work per
visibility runs as dense matrix products:

1. **Planning (host, once per channel)** — visibilities are sorted in
   Morton order of their UV tile and cut into *chunks* of at most ``Mc``
   visibilities whose kernel footprints fit a ``(Rv + K) x (Ru + K)``
   window (:func:`plan_chunks`).  Chunked arrays are padded to static
   shapes.  Because the preprocessor already sorts and compresses
   visibilities, consecutive records are spatially adjacent and chunks are
   dense in the UV centre.

2. **Assembly (device)** — for each chunk the separable kernel factors
   are expanded into two dense matrices
   ``V[r, m] = conj(kernel[wp_m, sub_v_m, r - (v0_m - anchor_v)])`` of
   shape ``(Rv + K, Mc)`` and
   ``U[m, c] = sample_m * conj(kernel[wp_m, sub_u_m, c - (u0_m - anchor_u)])``
   of shape ``(Mc, Ru + K)``.  ``assembly`` selects how: ``fft``
   (batched-iFFT phase-ramp materialization), ``tapdict`` (one gather per
   factor matrix from a precomputed (kernel row, in-tile shift)
   dictionary), ``matmul`` (iDFT matrices folded into the band product),
   ``tapsmm``, ``onehot`` and ``joint``.  :func:`default_assembly` picks
   one per platform.

3. **Accumulation (device)** — the chunk's grid contribution is the
   rank-``Mc`` product ``V @ U``.  The dense formulation computes all
   bands in parallel groups and lands them in a 4-colour tile array
   (same-colour windows are disjoint) folded into the grid with four
   dense shifted adds; the scan formulation accumulates windows
   sequentially with dynamic-slice read-modify-writes.  With
   ``Rv = Ru = 64`` and ``K = 60`` the matmul does
   :math:`(R+K)^2 M_c` useful-plus-padding work at ~23% density.

Degridding is the transpose: ``T = V^T @ window`` followed by a tap
contraction per visibility, with the same assembly choices.

Numerical semantics are identical to :mod:`.gridder` (same conventions,
different evaluation order; f32 sums reassociate).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

#: Matmul precision for every gridding contraction.  A float32 product at
#: the default precision may run in TF32 on an NVIDIA GPU (10-bit
#: mantissa, about three digits), which would put ~1e-3 relative errors
#: into the grid; HIGHEST keeps true f32 so the grid stays within the
#: 5e-7 f64-oracle gate.
_PRECISION = "highest"


# ---------------------------------------------------------------------------
# Host-side planning


class ChunkPlan(NamedTuple):
    """Static-shape chunked visibility layout (numpy, host-resident).

    All per-vis arrays are gathered into ``(n_chunks, Mc)`` layout; padding
    entries have ``valid == False`` and zeroed payloads.
    """

    uv: np.ndarray        # (C, Mc, 2) int32 centred cell coords
    sub_uv: np.ndarray    # (C, Mc, 2) int32
    w_plane: np.ndarray   # (C, Mc) int32
    vis: np.ndarray       # (C, Mc, P) complex64 (pre-weighted)
    weights: np.ndarray   # (C, Mc, P) float32
    anchor: np.ndarray    # (C, 2) int32: (v_row0, u_col0) grid indices of window
    valid: np.ndarray     # (C, Mc) bool
    row_chunk: np.ndarray  # (Nvis,) chunk index of each ORIGINAL input row
    row_slot: np.ndarray   # (Nvis,) slot within that chunk


def _morton_key(vt: np.ndarray, ut: np.ndarray) -> np.ndarray:
    """Interleave tile coordinate bits (16 bits each) into a Morton code."""
    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 16)) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x << 8)) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << 2)) & np.uint64(0x3333333333333333)
        x = (x | (x << 1)) & np.uint64(0x5555555555555555)
        return x

    return (spread(vt) << np.uint64(1)) | spread(ut)


def plan_chunks(uv, sub_uv, w_plane, vis, weights, *, pixels: int,
                kernel_width: int, rv: int = 64, ru: int = 64,
                mc: int = 256) -> ChunkPlan:
    """Build the chunk layout for one (channel, w_slice) visibility set.

    ``uv`` is the centred int16 cell coordinate from preprocessing.  The
    footprint's first grid index is ``uv - uv_bias`` (see
    :mod:`.gridder`); chunks guarantee every footprint fits the
    ``(rv + K, ru + K)`` window at the chunk anchor.
    """
    K = kernel_width
    n = len(uv)
    uv_bias = (K - 1) // 2 - pixels // 2
    if n == 0:
        zero = np.zeros
        return ChunkPlan(zero((0, mc, 2), np.int32), zero((0, mc, 2), np.int32),
                         zero((0, mc), np.int32),
                         zero((0, mc, vis.shape[1]), np.complex64),
                         zero((0, mc, vis.shape[1]), np.float32),
                         zero((0, 2), np.int32), zero((0, mc), bool),
                         zero((0,), np.int32), zero((0,), np.int32))

    u0 = uv[:, 0].astype(np.int64) - uv_bias  # first grid col of footprint
    v0 = uv[:, 1].astype(np.int64) - uv_bias  # first grid row
    key = _morton_key((v0 // rv).astype(np.int64), (u0 // ru).astype(np.int64))
    order = np.argsort(key, kind="stable")
    u0s, v0s = u0[order], v0[order]

    # Cut into chunks: greedy walk keeping count <= mc and bbox within
    # (rv, ru) of the chunk minimum.
    starts = [0]
    min_v = v0s[0]
    max_v = v0s[0]
    min_u = u0s[0]
    max_u = u0s[0]
    count = 0
    for i in range(n):
        nv_min, nv_max = min(min_v, v0s[i]), max(max_v, v0s[i])
        nu_min, nu_max = min(min_u, u0s[i]), max(max_u, u0s[i])
        if count >= mc or nv_max - nv_min > rv or nu_max - nu_min > ru:
            starts.append(i)
            min_v = max_v = v0s[i]
            min_u = max_u = u0s[i]
            count = 1
        else:
            min_v, max_v, min_u, max_u = nv_min, nv_max, nu_min, nu_max
            count += 1
    starts.append(n)
    starts = np.asarray(starts)
    n_chunks = len(starts) - 1
    # Round the chunk count up to a power of two so jit specialisations of
    # the scan are bounded; padding chunks are fully invalid.
    n_padded = 1
    while n_padded < n_chunks:
        n_padded *= 2

    P = vis.shape[1]
    c_uv = np.zeros((n_padded, mc, 2), np.int32)
    c_sub = np.zeros((n_padded, mc, 2), np.int32)
    c_wp = np.zeros((n_padded, mc), np.int32)
    c_vis = np.zeros((n_padded, mc, P), np.complex64)
    c_wt = np.zeros((n_padded, mc, P), np.float32)
    anchor = np.zeros((n_padded, 2), np.int32)
    valid = np.zeros((n_padded, mc), bool)
    chunk_of = np.zeros(n, np.int64)
    slot_of = np.zeros(n, np.int64)

    uv_s = uv[order]
    sub_s = sub_uv[order]
    wp_s = w_plane[order]
    vis_s = vis[order]
    wt_s = weights[order]
    for c in range(n_chunks):
        s, e = starts[c], starts[c + 1]
        m = e - s
        c_uv[c, :m] = uv_s[s:e]
        c_sub[c, :m] = sub_s[s:e]
        c_wp[c, :m] = wp_s[s:e]
        c_vis[c, :m] = vis_s[s:e]
        c_wt[c, :m] = wt_s[s:e]
        anchor[c, 0] = v0s[s:e].min()
        anchor[c, 1] = u0s[s:e].min()
        valid[c, :m] = True
        chunk_of[s:e] = c
        slot_of[s:e] = np.arange(m)

    row_chunk = np.empty(n, np.int32)
    row_slot = np.empty(n, np.int32)
    row_chunk[order] = chunk_of
    row_slot[order] = slot_of
    return ChunkPlan(c_uv, c_sub, c_wp, c_vis, c_wt, anchor, valid,
                     row_chunk, row_slot)


# ---------------------------------------------------------------------------
# Device-side gridding


def _chunk_factors(kernel, uv, sub_uv, w_plane, anchor, valid, *,
                   pixels: int, rv: int, ru: int):
    """Dense separable factors for one chunk (gather-only assembly).

    Returns (V (Rv+K, Mc) complex, Utap (Mc, Ru+K) complex, cell (vq, uq)).
    ``Utap`` excludes the per-vis sample (multiplied in by the caller).
    """
    K = kernel.shape[-1]
    uv_bias = (K - 1) // 2 - pixels // 2
    u0r = uv[:, 0] - uv_bias - anchor[1]  # offset of footprint in window
    v0r = uv[:, 1] - uv_bias - anchor[0]
    wp = w_plane

    ku = kernel[wp, sub_uv[:, 0], :]  # (Mc, K)
    kv = kernel[wp, sub_uv[:, 1], :]  # (Mc, K)
    ku = jnp.where(valid[:, None], ku, 0)
    kv = jnp.where(valid[:, None], kv, 0)

    # Scatter each vis's K kernel taps to its window offset via a
    # comparison-select reduction.
    taps = jnp.arange(K, dtype=jnp.int32)
    cols = jnp.arange(ru + K, dtype=jnp.int32)
    pos_u = u0r[:, None] + taps[None, :]            # (Mc, K)
    Utap = jnp.sum(
        jnp.where(cols[None, None, :] == pos_u[:, :, None],
                  ku[:, :, None], 0), axis=1)       # (Mc, Ru+K)

    rows = jnp.arange(rv + K, dtype=jnp.int32)
    pos_v = v0r[:, None] + taps[None, :]            # (Mc, K)
    Vt = jnp.sum(
        jnp.where(rows[None, None, :] == pos_v[:, :, None],
                  kv[:, :, None], 0), axis=1)       # (Mc, Rv+K)
    return Vt, Utap


def grid_chunks_impl(grid, kernel, weights_grid, plan_uv, plan_sub, plan_wp,
                     plan_vis, plan_anchor, plan_valid, *, pixels: int,
                     rv: int, ru: int):
    """Accumulate all chunks onto the grid (scan over chunks).

    grid: (P, N, N) complex (returned updated).  plan_*: stacked chunk
    arrays from :class:`ChunkPlan` (jnp).
    """
    K = kernel.shape[-1]
    Np = pixels
    half = Np // 2
    Pp = grid.shape[0]

    def body(g, xs):
        uv, sub, wp, vis, anchor, valid = xs
        Vt, Utap = _chunk_factors(kernel, uv, sub, wp, anchor, valid,
                                  pixels=Np, rv=rv, ru=ru)
        # density-weight lookup at the vis cell
        uq = uv[:, 0] + half
        vq = uv[:, 1] + half
        dw = weights_grid[:, vq, uq]                    # (P, Mc)
        sample = vis.T * dw                             # (P, Mc)
        V = jnp.conj(Vt).T                              # (Rv+K, Mc)
        Uc = jnp.conj(Utap)                             # (Mc, Ru+K)
        # (P, Rv+K, Ru+K) = V @ (sample * U) batched over P
        US = sample[:, :, None] * Uc[None, :, :]        # (P, Mc, Ru+K)
        band = jnp.einsum("rm,pmc->prc", V, US, precision=_PRECISION,
                          preferred_element_type=g.dtype)
        zero = jnp.zeros((), anchor.dtype)
        win = jax.lax.dynamic_slice(
            g, (zero, anchor[0], anchor[1]), (Pp, rv + K, ru + K))
        g = jax.lax.dynamic_update_slice(g, win + band,
                                         (zero, anchor[0], anchor[1]))
        return g, None

    grid, _ = jax.lax.scan(
        body, grid, (plan_uv, plan_sub, plan_wp, plan_vis, plan_anchor,
                     plan_valid))
    return grid


grid_chunks = partial(jax.jit,
                      static_argnames=("pixels", "rv", "ru"),
                      donate_argnums=(0,))(grid_chunks_impl)




# ---------------------------------------------------------------------------
# Tile-aligned planning + dense (scan-free) gridding
#
# The scan formulation above serializes chunks through a windowed
# read-modify-write of the grid carry.  The dense formulation removes the
# serial dependency: chunks are tile-aligned (anchor = tile * TS, window
# (TS+K)^2 with TS >= K), ALL bands are computed by one batched einsum, and
# bands land in a 4-colour tile array — same-colour windows are disjoint by
# construction — which folds into the grid with four dense shifted adds.


def plan_chunks_tiled_coords(uv, *, pixels: int, kernel_width: int,
                             ts: int = 64, mc: int = 256) -> dict:
    """Tile-aligned chunk ASSIGNMENT from coordinates alone.

    Streaming packers (cube wave batches over HDF5 spill files) use this
    with a coordinates-only read, then place payload blocks by the
    returned per-row mapping — host memory stays bounded by the block
    size instead of the slice size.

    Returns a dict: ``order`` (sorted permutation), ``chunk_of``/
    ``slot_of`` (per SORTED position), ``row_chunk``/``row_slot`` (per
    ORIGINAL row), ``anchor`` (n_padded, 2), ``valid`` (n_padded, mc),
    ``n_chunks``, ``n_padded``.
    """
    K = kernel_width
    assert K <= ts, "tile size must cover the kernel"
    n = len(uv)
    uv_bias = (K - 1) // 2 - pixels // 2
    if n == 0:
        return dict(order=np.zeros(0, np.int64),
                    chunk_of=np.zeros(0, np.int64),
                    slot_of=np.zeros(0, np.int64),
                    row_chunk=np.zeros(0, np.int64),
                    row_slot=np.zeros(0, np.int64),
                    anchor=np.zeros((0, 2), np.int32),
                    valid=np.zeros((0, mc), bool),
                    n_chunks=0, n_padded=0)

    u0 = uv[:, 0].astype(np.int64) - uv_bias
    v0 = uv[:, 1].astype(np.int64) - uv_bias
    tv = v0 // ts
    tu = u0 // ts
    ntu = -(-pixels // ts) + 1
    key = tv * ntu + tu
    # Tile keys span a tiny range ((pixels/ts + 1)^2); numpy's stable sort
    # for integers is a radix sort whose pass count scales with the dtype
    # width, so narrowing the key is ~8x (int16 vs int64 at 1.8M rows).
    key_max = (ntu - 1) * ntu + ntu - 1
    if key_max < np.iinfo(np.int16).max:
        key = key.astype(np.int16)
    elif key_max < np.iinfo(np.int32).max:
        key = key.astype(np.int32)
    order = np.argsort(key, kind="stable")
    key_s = key[order]

    # group boundaries per tile; chunks of <= mc within each tile
    starts = np.concatenate([[0], 1 + np.nonzero(np.diff(key_s))[0]])
    counts = np.diff(np.concatenate([starts, [n]]))
    chunks_per_tile = -(-counts // mc)
    chunk_base = np.concatenate([[0], np.cumsum(chunks_per_tile)])
    n_chunks = int(chunk_base[-1])
    n_padded = 1
    while n_padded < n_chunks:
        n_padded *= 2

    # per-vis local index within its tile group
    local = np.arange(n) - np.repeat(starts, counts)
    group_of = np.repeat(np.arange(len(counts)), counts)
    chunk_of = chunk_base[group_of] + local // mc
    slot_of = local % mc

    anchor = np.zeros((n_padded, 2), np.int32)
    valid = np.zeros((n_padded, mc), bool)
    valid[chunk_of, slot_of] = True
    anchor[chunk_of, 0] = (tv[order] * ts).astype(np.int32)
    anchor[chunk_of, 1] = (tu[order] * ts).astype(np.int32)

    row_chunk = np.empty(n, np.int64)
    row_slot = np.empty(n, np.int64)
    row_chunk[order] = chunk_of
    row_slot[order] = slot_of
    return dict(order=order, chunk_of=chunk_of, slot_of=slot_of,
                row_chunk=row_chunk, row_slot=row_slot, anchor=anchor,
                valid=valid, n_chunks=n_chunks, n_padded=n_padded)


def plan_chunks_tiled_count(uv, *, pixels: int, kernel_width: int,
                            ts: int = 64, mc: int = 256) -> int:
    """Number of chunks :func:`plan_chunks_tiled_coords` would produce.

    Layout sizing (cube ``_plan_layout``) only needs the chunk count; a
    bincount over tile keys gives it in O(n) without the argsort (the
    count per tile is order-independent), ~40x cheaper than a full plan.
    """
    n = len(uv)
    if n == 0:
        return 0
    K = kernel_width
    uv_bias = (K - 1) // 2 - pixels // 2
    tv = (uv[:, 1].astype(np.int64) - uv_bias) // ts
    tu = (uv[:, 0].astype(np.int64) - uv_bias) // ts
    ntu = -(-pixels // ts) + 1
    counts = np.bincount(tv * ntu + tu)
    return int(np.sum(-(-counts[counts > 0] // mc)))


def plan_chunks_tiled(uv, sub_uv, w_plane, vis, weights, *, pixels: int,
                      kernel_width: int, ts: int = 64,
                      mc: int = 256) -> "ChunkPlan":
    """Tile-aligned chunk plan (vectorized, no python walk).

    Requires ``kernel_width <= ts``.  Returns a :class:`ChunkPlan` whose
    anchors are multiples of ``ts`` (windows ``(ts+K)^2``).
    """
    n = len(uv)
    if n == 0:
        return plan_chunks(uv, sub_uv, w_plane, vis, weights, pixels=pixels,
                           kernel_width=kernel_width, rv=ts, ru=ts, mc=mc)
    P = vis.shape[1]

    from .. import native
    if native.available():
        # Parallel C++ counting-sort pack (bitwise-identical layout;
        # tests/test_native.py) — plans, orders and scatters in one pass.
        n_padded = 1
        while n_padded < plan_chunks_tiled_count(
                uv, pixels=pixels, kernel_width=kernel_width, ts=ts, mc=mc):
            n_padded *= 2
        c_uv = np.zeros((n_padded, mc, 2), np.int32)
        c_sub = np.zeros((n_padded, mc, 2), np.int32)
        c_wp = np.zeros((n_padded, mc), np.int32)
        anchor = np.zeros((n_padded, 2), np.int32)
        valid = np.zeros((n_padded, mc), bool)
        _, row_chunk, row_slot = native.pack_slice_coords(
            uv, sub_uv, w_plane, pixels=pixels, kernel_width=kernel_width,
            ts=ts, mc=mc, out_uv=c_uv, out_sub=c_sub, out_wp=c_wp,
            out_anchor=anchor, out_valid=valid)
        c_vis = np.zeros((n_padded, mc, P), np.complex64)
        c_wt = np.zeros((n_padded, mc, P), np.float32)
        native.place_payload(row_chunk, row_slot,
                             np.ascontiguousarray(weights, np.float32),
                             np.ascontiguousarray(vis, np.complex64),
                             c_wt, c_vis)
        return ChunkPlan(c_uv, c_sub, c_wp, c_vis, c_wt, anchor, valid,
                         row_chunk, row_slot)

    asg = plan_chunks_tiled_coords(uv, pixels=pixels,
                                   kernel_width=kernel_width, ts=ts, mc=mc)
    order, chunk_of, slot_of = asg["order"], asg["chunk_of"], asg["slot_of"]
    n_padded = asg["n_padded"]

    c_uv = np.zeros((n_padded, mc, 2), np.int32)
    c_sub = np.zeros((n_padded, mc, 2), np.int32)
    c_wp = np.zeros((n_padded, mc), np.int32)
    c_vis = np.zeros((n_padded, mc, P), np.complex64)
    c_wt = np.zeros((n_padded, mc, P), np.float32)

    c_uv[chunk_of, slot_of] = uv[order]
    c_sub[chunk_of, slot_of] = sub_uv[order]
    c_wp[chunk_of, slot_of] = w_plane[order]
    c_vis[chunk_of, slot_of] = vis[order]
    c_wt[chunk_of, slot_of] = weights[order]

    return ChunkPlan(c_uv, c_sub, c_wp, c_vis, c_wt, asg["anchor"],
                     asg["valid"], asg["row_chunk"].astype(np.int32),
                     asg["row_slot"].astype(np.int32))




@partial(jax.jit, static_argnames=("pixels", "kernel_width", "ts", "mc",
                                   "nc"))
def plan_chunks_tiled_device(uv, sub_uv, w_plane, vis, weights, *,
                             pixels: int, kernel_width: int, ts: int,
                             mc: int, nc: int):
    """Device-side (jittable) equivalent of :func:`plan_chunks_tiled`.

    Produces the identical chunk layout — same stable sort by tile key,
    same chunk/slot assignment — entirely as XLA ops (sort, cumsum-based
    segmentation, scatter), so cube waves need no host planning pass.
    ``nc`` is the static chunk capacity; chunks beyond it are dropped
    (the returned ``n_chunks`` lets the caller validate sizing).

    Returns a dict with the :class:`ChunkPlan` array fields (uv, sub_uv,
    w_plane, vis, weights, anchor, valid, order, chunk_of, slot_of) plus
    ``n_chunks``.
    """
    K = kernel_width
    n = uv.shape[0]
    P = vis.shape[1]
    uv_bias = (K - 1) // 2 - pixels // 2

    u0 = uv[:, 0].astype(jnp.int32) - uv_bias
    v0 = uv[:, 1].astype(jnp.int32) - uv_bias
    tv = v0 // ts
    tu = u0 // ts
    ntu = -(-pixels // ts) + 1
    key = tv * ntu + tu
    order = jnp.argsort(key, stable=True)
    key_s = key[order]

    idx = jnp.arange(n, dtype=jnp.int32)
    new_group = jnp.concatenate(
        [jnp.ones((1,), bool), key_s[1:] != key_s[:-1]])
    # start index of each element's group: cummax of start positions
    start = jax.lax.cummax(jnp.where(new_group, idx, 0))
    local = idx - start
    new_chunk = new_group | (local % mc == 0)
    chunk_of = jnp.cumsum(new_chunk.astype(jnp.int32)) - 1
    slot_of = local % mc
    n_chunks = chunk_of[-1] + 1 if n else jnp.zeros((), jnp.int32)

    def scat(shape, dtype, values):
        out = jnp.zeros(shape, dtype)
        return out.at[chunk_of, slot_of].set(values, mode="drop")

    c_uv = scat((nc, mc, 2), jnp.int32, uv[order].astype(jnp.int32))
    c_sub = scat((nc, mc, 2), jnp.int32, sub_uv[order].astype(jnp.int32))
    c_wp = scat((nc, mc), jnp.int32, w_plane[order].astype(jnp.int32))
    c_vis = scat((nc, mc, P), vis.dtype, vis[order])
    c_wt = scat((nc, mc, P), weights.dtype, weights[order])
    valid = scat((nc, mc), jnp.bool_, jnp.ones((n,), bool))
    anchor = jnp.zeros((nc, 2), jnp.int32)
    anchor = anchor.at[chunk_of, 0].set((tv[order] * ts).astype(jnp.int32),
                                        mode="drop")
    anchor = anchor.at[chunk_of, 1].set((tu[order] * ts).astype(jnp.int32),
                                        mode="drop")
    row_chunk = jnp.zeros((n,), jnp.int32).at[order].set(chunk_of)
    row_slot = jnp.zeros((n,), jnp.int32).at[order].set(
        slot_of.astype(jnp.int32))
    return dict(uv=c_uv, sub_uv=c_sub, w_plane=c_wp, vis=c_vis,
                weights=c_wt, anchor=anchor, valid=valid,
                row_chunk=row_chunk, row_slot=row_slot, n_chunks=n_chunks)


def _fft_pad_len(tsk: int) -> int:
    """FFT length for spectral factor assembly: next power of two >= tsk."""
    L = 1
    while L < tsk:
        L *= 2
    return L


def _chunk_factors_fft(kernel_fft, kernel_width, uv, sub_uv, w_plane,
                       anchor, valid, *, pixels: int, rv: int, ru: int):
    """Spectral factor assembly: a one-hot tap shift is a phase ramp.

    ``kernel_fft`` is ``fft(pad(kernel, (0, L-K)), axis=-1)`` of the
    (W, O, K) table with L = _fft_pad_len(ts + K).  Per visibility the
    shifted kernel row is ``ifft(kernel_fft[wp, sub] * exp(-2pi i f u0r/L))``
    — a row gather, a complex ramp and one batched iFFT instead of the
    (Mc, K, R+K) comparison-select reduction (~10x less VPU work at K=60).
    Exact (no circular wraparound): u0r + K <= ts + K <= L.
    """
    K = kernel_width
    L = kernel_fft.shape[-1]
    uv_bias = (K - 1) // 2 - pixels // 2
    u0r = uv[:, 0] - uv_bias - anchor[1]
    v0r = uv[:, 1] - uv_bias - anchor[0]
    wp = w_plane

    spec_u = kernel_fft[wp, sub_uv[:, 0], :]   # (Mc, L)
    spec_v = kernel_fft[wp, sub_uv[:, 1], :]
    freqs = jnp.arange(L, dtype=jnp.float32) * (2 * np.pi / L)
    phase_u = -freqs[None, :] * u0r.astype(jnp.float32)[:, None]
    phase_v = -freqs[None, :] * v0r.astype(jnp.float32)[:, None]
    ramp_u = jax.lax.complex(jnp.cos(phase_u), jnp.sin(phase_u))
    ramp_v = jax.lax.complex(jnp.cos(phase_v), jnp.sin(phase_v))
    Utap = jnp.fft.ifft(spec_u * ramp_u, axis=-1)[:, :ru + K]
    Vt = jnp.fft.ifft(spec_v * ramp_v, axis=-1)[:, :rv + K]
    mask = valid[:, None]
    cdtype = kernel_fft.dtype
    return (jnp.where(mask, Vt, 0).astype(cdtype),
            jnp.where(mask, Utap, 0).astype(cdtype))


def grid_chunks_dense_impl(grid_pad, kernel, weights_grid, plan_uv, plan_sub,
                           plan_wp, plan_vis, plan_anchor, plan_valid,
                           dw_chunks=None, n_chunks=None, *, pixels: int,
                           ts: int, group: int | None = None,
                           assembly: str = "fft"):
    """Scan-free gridding: batched band einsum + 4-colour dense combine.

    ``grid_pad`` is (P, pixels + 4*ts, pixels + 4*ts) complex (zero-padded
    working copy; caller crops).  Anchors must be tile-aligned
    (:func:`plan_chunks_tiled`).

    ``n_chunks`` (optional traced scalar) is the number of OCCUPIED chunks;
    the plan layouts place occupied chunks first, so when given, the group
    loop runs ``ceil(n_chunks / group)`` iterations (a dynamic
    ``fori_loop`` bound) and cost tracks valid visibilities instead of the
    padded layout capacity — a large win for capacity-sized cube layouts
    at partial fill.

    ``assembly`` selects how per-visibility kernel taps become bands:

    - ``"fft"``: materialize shifted tap rows by batched iFFT
      (:func:`_chunk_factors_fft`), then one band einsum.  Fast where the
      backend's FFT is fast (CPU).
    - ``"matmul"``: never materialize taps.  With ``G[k, t] = e^{2pi i
      k t / L} / L`` (the iDFT matrix) the band is ``conj(G^T @ core @ G)``
      where ``core[p, k, l] = sum_m Sv[m, k] conj(sample[p, m]) Su[m, l]``
      and ``Su/Sv`` are the spectral kernel rows times the shift phase
      ramps.  Three L-sized matmuls per chunk, no FFT.
    - ``"tapsmm"``: materialize shifted taps by a single large GEMM per
      group — ``B = S @ G[:, :ts+K]`` with ``S`` the ``(group*Mc, L)``
      stack of spectral rows×ramps — then one batched band product per
      group.  Mathematically identical to ``"fft"`` (the GEMM *is* the
      iDFT) but it moves two thirds of the flops from batched small
      matmuls into one large contraction.
    """
    if group is None:
        # Small groups keep the band-scatter working set down for the
        # matmul assemblies; the iFFT path amortizes its FFT batches over
        # large groups.
        group = 128 if assembly != "fft" else 2048
    K = kernel.shape[-1]
    Np = pixels
    half = Np // 2
    Pp = grid_pad.shape[0]
    NC = plan_uv.shape[0]
    TSK = ts + K
    TS2 = 2 * ts
    ntv = -(-Np // ts) + 1            # tiles per axis (with margin)
    nt2 = -(-ntv // 2) + 1            # same-colour tiles per axis

    L = _fft_pad_len(TSK)
    assert L <= TS2, "ts must be a power-of-two multiple covering K"
    kernel_fft = jnp.fft.fft(
        jnp.pad(kernel, ((0, 0), (0, 0), (0, L - K))), axis=-1
    ).astype(kernel.dtype)
    W, O = kernel.shape[0], kernel.shape[1]
    kflat = kernel_fft.reshape(W * O, L)
    uv_bias = (K - 1) // 2 - Np // 2
    if assembly != "fft":
        tk = np.arange(L)
        G = jnp.asarray(
            np.exp(2j * np.pi * np.outer(tk, tk) / L).astype(np.complex64)
            / L)
        # Shift phase ramps exp(-2pi i f o / L) for integer in-window
        # offsets o: tile-aligned plans put o in [0, ts), so the ramps are
        # a tiny dictionary — a row gather replaces ~(Mc*L) cos/sin pairs
        # per chunk (exact, not an approximation).
        ramp_tab = jnp.asarray(np.exp(
            -2j * np.pi * np.outer(np.arange(TS2), tk) / L
        ).astype(np.complex64))
    if assembly == "onehot":
        # Row selection as one-hot matmuls instead of row gathers.  The
        # one-hot operand is exact at any precision, but the table operand
        # must stay full f32 (a TF32 pass would round it), so the products
        # run at _PRECISION — bit-comparable to the f32 gather path.
        kflat_ri = jnp.concatenate([kflat.real, kflat.imag], axis=-1)
        ramp_ri = jnp.concatenate([ramp_tab[:ts].real,
                                   ramp_tab[:ts].imag], axis=-1)

        def onehot_S(idx, off):
            oh_spec = (idx[:, None] == jnp.arange(W * O, dtype=idx.dtype)
                       ).astype(jnp.float32)
            oh_ramp = (off[:, None] == jnp.arange(ts, dtype=off.dtype)
                       ).astype(jnp.float32)
            sp = jnp.dot(oh_spec, kflat_ri, precision=_PRECISION)
            rp = jnp.dot(oh_ramp, ramp_ri, precision=_PRECISION)
            return (jax.lax.complex(sp[:, :L], sp[:, L:])
                    * jax.lax.complex(rp[:, :L], rp[:, L:]))
    if assembly == "joint":
        # One gather instead of two + an elementwise pass: precompute the
        # joint table ``kflat[j] * ramp[o]`` over all (kernel row, shift)
        # pairs — (W*O*ts, L) complex, built once per call — and gather
        # Su/Sv rows by the fused index.  Halves the assembly-stage HBM
        # traffic relative to ``matmul``.
        joint_tab = (kflat[:, None, :]
                     * ramp_tab[None, :ts, :]).reshape(W * O * ts, L)
    if assembly == "tapdict":
        # Go one step further than ``joint``: precompute the fully *shifted
        # tap rows* — ``taps_tab[(j, o), t] = kernel[j, t - o]`` for every
        # (kernel row, in-tile shift) pair, (W*O*ts, ts+K) complex — so a
        # chunk needs ONE row gather per factor matrix and ONE rank-Mc band
        # matmul: no spectral core, no G transforms.  Exact (integer-shift
        # placement, no DFT roundoff); table is ~16 MB at the 4k/K=60/
        # 32-w-plane point and is built once per call.
        kr = kernel.reshape(W * O, K)
        rel = np.arange(TSK)[None, :] - np.arange(ts)[:, None]  # (ts, TSK)
        mask_np = (rel >= 0) & (rel < K)
        relc = np.clip(rel, 0, K - 1)
        taps_tab = jnp.where(
            jnp.asarray(mask_np)[None], kr[:, jnp.asarray(relc)], 0
        ).reshape(W * O * ts, TSK)

    n_groups = -(-NC // group)
    pad_nc = n_groups * group - NC

    def padg(a):
        return jnp.pad(a, [(0, pad_nc)] + [(0, 0)] * (a.ndim - 1))

    uv_g = padg(plan_uv).reshape(n_groups, group, -1, 2)
    sub_g = padg(plan_sub).reshape(n_groups, group, -1, 2)
    wp_g = padg(plan_wp).reshape(n_groups, group, -1)
    vis_g = padg(plan_vis).reshape(n_groups, group, -1, Pp)
    anc_g = padg(plan_anchor).reshape(n_groups, group, 2)
    val_g = padg(plan_valid).reshape(n_groups, group, -1)
    if dw_chunks is not None:
        dw_g = padg(dw_chunks).reshape(n_groups, group, -1, Pp)
    else:
        dw_g = None

    # Per-vis density lookups: a chunk's cells lie inside a (ts, ts)
    # window at its anchor, so slice the window (one dense DMA read) and
    # gather locally instead of issuing Mc random HBM gathers per chunk.
    # ``weights_grid=None`` means natural weighting (density == 1): skip
    # the lookup entirely.
    _kb = (K - 1) // 2
    wg_pad = (None if dw_chunks is not None or weights_grid is None
              else jnp.pad(weights_grid, ((0, 0), (0, ts), (0, ts))))

    def group_body(T, xs):
        if dw_g is None:
            uv, sub, wp, vis, anchor, valid = xs
            dwx = None
        else:
            uv, sub, wp, vis, anchor, valid, dwx = xs

        def sample_of(uv_c, anc_c, vis_c, val_c, dw_c):
            if dw_c is None and wg_pad is None:
                return vis_c.T * val_c[None, :]
            if dw_c is None:
                zero = jnp.zeros((), anc_c.dtype)
                win = jax.lax.dynamic_slice(
                    wg_pad, (zero, anc_c[0] + _kb, anc_c[1] + _kb),
                    (Pp, ts, ts))
                u0r = jnp.clip(uv_c[:, 0] - uv_bias - anc_c[1], 0, ts - 1)
                v0r = jnp.clip(uv_c[:, 1] - uv_bias - anc_c[0], 0, ts - 1)
                dw = win[:, v0r, u0r]
            else:
                dw = dw_c.T
            return vis_c.T * dw * val_c[None, :]

        def one_fft(uv_c, sub_c, wp_c, vis_c, anc_c, val_c, dw_c):
            Vt, Utap = _chunk_factors_fft(kernel_fft, K, uv_c, sub_c, wp_c,
                                          anc_c, val_c, pixels=Np, rv=ts,
                                          ru=ts)
            sample = sample_of(uv_c, anc_c, vis_c, val_c, dw_c)
            V = jnp.conj(Vt).T
            US = sample[:, :, None] * jnp.conj(Utap)[None, :, :]
            band = jnp.einsum("rm,pmc->prc", V, US,
                              precision=_PRECISION,
                              preferred_element_type=grid_pad.dtype)
            return jnp.pad(band, ((0, 0), (0, TS2 - TSK), (0, TS2 - TSK)))

        def one_tapdict(uv_c, sub_c, wp_c, vis_c, anc_c, val_c, dw_c):
            u0r = jnp.clip(uv_c[:, 0] - uv_bias - anc_c[1], 0, ts - 1)
            v0r = jnp.clip(uv_c[:, 1] - uv_bias - anc_c[0], 0, ts - 1)
            Utap = taps_tab[(wp_c * O + sub_c[:, 0]) * ts + u0r]  # (Mc,TSK)
            Vt = taps_tab[(wp_c * O + sub_c[:, 1]) * ts + v0r]
            # invalid slots gather garbage rows; their samples are zero, so
            # the rank-1 terms they contribute vanish.
            sample = sample_of(uv_c, anc_c, vis_c, val_c, dw_c)
            V = jnp.conj(Vt).T
            US = sample[:, :, None] * jnp.conj(Utap)[None, :, :]
            band = jnp.einsum("rm,pmc->prc", V, US,
                              precision=_PRECISION,
                              preferred_element_type=grid_pad.dtype)
            return jnp.pad(band, ((0, 0), (0, TS2 - TSK), (0, TS2 - TSK)))

        def one_matmul(uv_c, sub_c, wp_c, vis_c, anc_c, val_c, dw_c):
            if assembly == "onehot":
                # tile-aligned plans put offsets in [0, ts); padding slots
                # may clip anywhere — their samples are masked to zero.
                u0r = jnp.clip(uv_c[:, 0] - uv_bias - anc_c[1], 0, ts - 1)
                v0r = jnp.clip(uv_c[:, 1] - uv_bias - anc_c[0], 0, ts - 1)
                Su = onehot_S(wp_c * O + sub_c[:, 0], u0r)
                Sv = onehot_S(wp_c * O + sub_c[:, 1], v0r)
            elif assembly == "joint":
                u0r = jnp.clip(uv_c[:, 0] - uv_bias - anc_c[1], 0, ts - 1)
                v0r = jnp.clip(uv_c[:, 1] - uv_bias - anc_c[0], 0, ts - 1)
                Su = joint_tab[(wp_c * O + sub_c[:, 0]) * ts + u0r]
                Sv = joint_tab[(wp_c * O + sub_c[:, 1]) * ts + v0r]
            else:
                u0r = jnp.clip(uv_c[:, 0] - uv_bias - anc_c[1], 0, TS2 - 1)
                v0r = jnp.clip(uv_c[:, 1] - uv_bias - anc_c[0], 0, TS2 - 1)
                spec_u = kflat[wp_c * O + sub_c[:, 0]]   # (Mc, L)
                spec_v = kflat[wp_c * O + sub_c[:, 1]]
                Su = spec_u * ramp_tab[u0r]
                Sv = spec_v * ramp_tab[v0r]
            sample = sample_of(uv_c, anc_c, vis_c, val_c, dw_c)
            core = jnp.einsum("mk,pm,ml->pkl", Sv, jnp.conj(sample), Su,
                              precision=_PRECISION,
                              preferred_element_type=grid_pad.dtype)
            band = jnp.einsum("kr,pkl,lc->prc", G, core, G,
                              precision=_PRECISION,
                              preferred_element_type=grid_pad.dtype)
            band = jnp.conj(band)
            return jnp.pad(band, ((0, 0), (0, TS2 - L), (0, TS2 - L)))

        def group_tapsmm(uv, sub, wp, vis, anchor, valid, dwx):
            # Whole-group tap materialization: one (g*Mc, L) @ (L, TSK)
            # GEMM per axis, then one batched band product.  B rows for
            # invalid slots are garbage; `sample` is masked so they
            # contribute zero.
            g, Mc = wp.shape
            u0r = jnp.clip(uv[..., 0] - uv_bias - anchor[:, None, 1],
                           0, TS2 - 1)                         # (g, Mc)
            v0r = jnp.clip(uv[..., 1] - uv_bias - anchor[:, None, 0],
                           0, TS2 - 1)
            spec_u = kflat[wp * O + sub[..., 0]]               # (g, Mc, L)
            spec_v = kflat[wp * O + sub[..., 1]]
            Su = spec_u * ramp_tab[u0r]
            Sv = spec_v * ramp_tab[v0r]
            Gt = G[:, :TSK]
            Bu = jnp.matmul(Su.reshape(g * Mc, L), Gt,
                            precision=_PRECISION).reshape(g, Mc, TSK)
            Bv = jnp.matmul(Sv.reshape(g * Mc, L), Gt,
                            precision=_PRECISION).reshape(g, Mc, TSK)
            if dwx is None:
                sample = jax.vmap(
                    lambda uv_c, anc_c, vis_c, val_c: sample_of(
                        uv_c, anc_c, vis_c, val_c, None))(uv, anchor, vis,
                                                          valid)
            else:
                sample = jax.vmap(sample_of)(uv, anchor, vis, valid, dwx)
            # band[g,p,r,c] = sum_m conj(Bv)[g,m,r] sample[g,p,m] conj(Bu)[g,m,c]
            US = sample[..., None] * jnp.conj(Bu)[:, None, :, :]
            band = jnp.einsum("gmr,gpmc->gprc", jnp.conj(Bv), US,
                              precision=_PRECISION,
                              preferred_element_type=grid_pad.dtype)
            return jnp.pad(band, ((0, 0), (0, 0), (0, TS2 - TSK),
                                  (0, TS2 - TSK)))

        if assembly == "tapsmm":
            bands = group_tapsmm(uv, sub, wp, vis, anchor, valid, dwx)
        else:
            one = {"fft": one_fft,
                   "tapdict": one_tapdict}.get(assembly, one_matmul)
            if dwx is None:
                bands = jax.vmap(
                    lambda a, b, c, d, e, f: one(a, b, c, d, e, f, None)
                )(uv, sub, wp, vis, anchor, valid)
            else:
                bands = jax.vmap(one)(uv, sub, wp, vis, anchor, valid, dwx)
        tv = anchor[:, 0] // ts
        tu = anchor[:, 1] // ts
        T = T.at[tv & 1, tu & 1, tv >> 1, tu >> 1].add(bands)
        return T, None

    T0 = jnp.zeros((2, 2, nt2, nt2, Pp, TS2, TS2), grid_pad.dtype)
    xs = ((uv_g, sub_g, wp_g, vis_g, anc_g, val_g) if dw_g is None
          else (uv_g, sub_g, wp_g, vis_g, anc_g, val_g, dw_g))
    if n_chunks is None:
        T, _ = jax.lax.scan(group_body, T0, xs)
    else:
        ng = jnp.minimum((n_chunks + group - 1) // group,
                         n_groups).astype(jnp.int32)

        def body_at(i, T):
            xsi = tuple(jax.lax.dynamic_index_in_dim(a, i, 0, keepdims=False)
                        for a in xs)
            T, _ = group_body(T, xsi)
            return T

        T = jax.lax.fori_loop(0, ng, body_at, T0)

    # Four dense shifted adds: colour (a, b) tiles form a contiguous image.
    ext = nt2 * TS2
    for a in range(2):
        for b in range(2):
            # (tv2, tu2, P, y, x) -> (P, tv2*TS2 + y, tu2*TS2 + x)
            img = T[a, b].transpose(2, 0, 3, 1, 4).reshape(Pp, ext, ext)
            grid_pad = grid_pad.at[:, a * ts:a * ts + ext,
                                   b * ts:b * ts + ext].add(img)
    return grid_pad


def dense_pad_size(pixels: int, ts: int) -> int:
    """Padded grid extent required by :func:`grid_chunks_dense_impl`."""
    ntv = -(-pixels // ts) + 1
    nt2 = -(-ntv // 2) + 1
    return ts + nt2 * 2 * ts


def grid_chunks_parts_impl(kernel, weights_grid, plan_uv, plan_sub,
                           plan_wp, plan_vis, plan_anchor, plan_valid,
                           dw_chunks=None, n_chunks=None, *, pixels: int,
                           ts: int, assembly: str = "fft"):
    """Grid onto a zero base grid and return the cropped (P, N, N) grid as
    f32 ``(gr, gi)`` planes (callers with a running grid use
    :func:`grid_chunks_dense_impl`)."""
    Pp_ = plan_vis.shape[-1]
    ext = dense_pad_size(pixels, ts)
    gpad = jnp.zeros((Pp_, ext, ext), jnp.complex64)
    gpad = grid_chunks_dense_impl(
        gpad, kernel, weights_grid, plan_uv, plan_sub, plan_wp, plan_vis,
        plan_anchor, plan_valid, dw_chunks, n_chunks,
        pixels=pixels, ts=ts, assembly=assembly)
    g = gpad[:, :pixels, :pixels]
    return (jnp.real(g).astype(jnp.float32),
            jnp.imag(g).astype(jnp.float32))


grid_chunks_dense = partial(jax.jit,
                            static_argnames=("pixels", "ts", "group",
                                             "assembly"),
                            donate_argnums=(0,))(grid_chunks_dense_impl)


def occupied_chunks(valid) -> jnp.ndarray:
    """Number of occupied chunks of an occupied-first (NC, Mc) valid mask.

    Both planners assign chunk indices in sorted order with padding chunks
    at the end, so this bounds the dense group loops (``n_chunks``)."""
    return jnp.sum(jnp.any(jnp.asarray(valid), axis=-1).astype(jnp.int32))


#: Per-channel gridder formulation per JAX platform: "dense" computes all
#: bands in parallel; "scan" accumulates chunk windows in sequence (cheap
#: on the CPU, where padding hurts).  On an H100 80GB HBM3 (700 W) dense
#: grids a 512k-visibility 4k slice in 12.0 ms against scan's 214 ms
#: (benchmarks/gpu_defaults.py).
GPU_MODE = "dense"
_MODE = {"cpu": "scan", "gpu": GPU_MODE}

#: Band assembly per JAX platform.  The CPU runs the iFFT materialization
#: (XLA's CPU FFT is fast there).  GPU_ASSEMBLY is the fastest assembly
#: that meets the 5e-7 grid gate on an H100 80GB HBM3 (700 W): 10.3 ms
#: grid + 8.4 ms degrid per 512k-visibility 4k slice, against 14.5 +
#: 12.7 for the runner-up "matmul"; "fft" misses the gate (6e-6, its
#: float32 phase ramps) (benchmarks/gpu_defaults.py).
GPU_ASSEMBLY = "tapdict"
_ASSEMBLY = {"cpu": "fft", "gpu": GPU_ASSEMBLY}


def supported_platform(platform: str | None = None) -> str:
    """The JAX platform the imager runs on: ``"cpu"`` or ``"gpu"``.

    ``platform`` defaults to the first device's; any other platform is an
    error rather than a silent CPU-tuned default."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform not in _ASSEMBLY:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: the imager runs on the "
            "CPU or an NVIDIA GPU")
    return platform


def default_assembly(platform: str | None = None) -> str:
    """Band-assembly default for ``platform`` (see :data:`_ASSEMBLY`)."""
    return _ASSEMBLY[supported_platform(platform)]


def degrid_chunks_impl(grid, kernel, plan_uv, plan_sub, plan_wp, plan_wt,
                       plan_vis, plan_anchor, plan_valid, n_chunks=None, *,
                       pixels: int, rv: int, ru: int,
                       group: int | None = None, assembly: str = "fft"):
    """Predict + subtract for all chunks; returns updated (C, Mc, P) vis.

    ``grid`` is the (P, >=N, >=N) complex model grid, or an f32
    ``(gre, gim)`` pair.  Chunk windows are read-only, so
    chunks evaluate in parallel (vmap) within memory-bounded groups.
    ``assembly`` as in :func:`grid_chunks_dense_impl`: ``"matmul"``
    evaluates the transposed spectral form
    ``predicted = (Sv (G win G^T)) . Su`` with no iFFT; ``"tapsmm"``
    materializes taps with one large GEMM per group.  ``n_chunks``
    (traced scalar) bounds the group loop to occupied chunks
    (occupied-first layouts); unprocessed padding chunks pass their vis
    through unchanged.
    """
    if isinstance(grid, tuple):
        grid = jax.lax.complex(grid[0], grid[1])
    if group is None:
        group = 128 if assembly != "fft" else 512
    K = kernel.shape[-1]
    Np = pixels
    Pp = plan_vis.shape[-1]
    NC = plan_uv.shape[0]
    L = _fft_pad_len(max(rv, ru) + K)
    kernel_fft = jnp.fft.fft(
        jnp.pad(kernel, ((0, 0), (0, 0), (0, L - K))), axis=-1
    ).astype(kernel.dtype)
    W, O = kernel.shape[0], kernel.shape[1]
    kflat = kernel_fft.reshape(W * O, L)
    uv_bias = (K - 1) // 2 - Np // 2
    if assembly != "fft":
        tk = np.arange(L)
        G = jnp.asarray(
            np.exp(2j * np.pi * np.outer(tk, tk) / L).astype(np.complex64)
            / L)
        Gr = G[:, :rv + K]
        Gc = G[:, :ru + K]
        # integer shift-offset ramp dictionary (see grid_chunks_dense_impl)
        ramp_tab = jnp.asarray(np.exp(
            -2j * np.pi * np.outer(np.arange(L), tk) / L
        ).astype(np.complex64))
    if assembly == "onehot":
        # One-hot matmul row selection instead of gathers (see
        # grid_chunks_dense_impl); non-tiled plans bound the in-window
        # offset by the chunk bbox constraint, i.e. [0, max(rv, ru)].
        R_off = max(rv, ru) + 1
        kflat_ri = jnp.concatenate([kflat.real, kflat.imag], axis=-1)
        ramp_ri = jnp.concatenate([ramp_tab[:R_off].real,
                                   ramp_tab[:R_off].imag], axis=-1)

        def onehot_S(idx, off):
            oh_spec = (idx[:, None] == jnp.arange(W * O, dtype=idx.dtype)
                       ).astype(jnp.float32)
            oh_ramp = (off[:, None] == jnp.arange(R_off, dtype=off.dtype)
                       ).astype(jnp.float32)
            sp = jnp.dot(oh_spec, kflat_ri, precision=_PRECISION)
            rp = jnp.dot(oh_ramp, ramp_ri, precision=_PRECISION)
            return (jax.lax.complex(sp[:, :L], sp[:, L:])
                    * jax.lax.complex(rp[:, :L], rp[:, L:]))
    if assembly == "joint":
        # Fused (kernel row, shift) table: one gather per factor matrix
        # (see grid_chunks_dense_impl).
        R_off = max(rv, ru) + 1
        joint_tab = (kflat[:, None, :]
                     * ramp_tab[None, :R_off, :]).reshape(W * O * R_off, L)
    if assembly == "tapdict":
        # Precomputed shifted tap rows (see grid_chunks_dense_impl).
        R_off = max(rv, ru) + 1
        TL = max(rv, ru) + K
        kr = kernel.reshape(W * O, K)
        rel = np.arange(TL)[None, :] - np.arange(R_off)[:, None]
        mask_np = (rel >= 0) & (rel < K)
        relc = np.clip(rel, 0, K - 1)
        taps_tab = jnp.where(
            jnp.asarray(mask_np)[None], kr[:, jnp.asarray(relc)], 0
        ).reshape(W * O * R_off, TL)

    def window(anchor):
        return jax.lax.dynamic_slice(
            grid, (jnp.zeros((), anchor.dtype), anchor[0], anchor[1]),
            (Pp, rv + K, ru + K))

    def one_fft(uv, sub, wp, wt, vis, anchor, valid):
        Vt, Utap = _chunk_factors_fft(kernel_fft, K, uv, sub, wp, anchor,
                                      valid, pixels=Np, rv=rv, ru=ru)
        win = window(anchor)
        # T[p, m, c] = sum_r Vt[m, r] win[p, r, c]
        T = jnp.einsum("mr,prc->pmc", Vt, win, precision=_PRECISION,
                       preferred_element_type=grid.dtype)
        predicted = jnp.sum(T * Utap[None, :, :], axis=-1)  # (P, Mc)
        return vis - wt * predicted.T.astype(vis.dtype)

    def one_matmul(uv, sub, wp, wt, vis, anchor, valid):
        if assembly == "onehot":
            u0r = jnp.clip(uv[:, 0] - uv_bias - anchor[1], 0, R_off - 1)
            v0r = jnp.clip(uv[:, 1] - uv_bias - anchor[0], 0, R_off - 1)
            Su = onehot_S(wp * O + sub[:, 0], u0r)
            Sv = onehot_S(wp * O + sub[:, 1], v0r)
        elif assembly == "joint":
            u0r = jnp.clip(uv[:, 0] - uv_bias - anchor[1], 0, R_off - 1)
            v0r = jnp.clip(uv[:, 1] - uv_bias - anchor[0], 0, R_off - 1)
            Su = joint_tab[(wp * O + sub[:, 0]) * R_off + u0r]
            Sv = joint_tab[(wp * O + sub[:, 1]) * R_off + v0r]
        else:
            u0r = jnp.clip(uv[:, 0] - uv_bias - anchor[1], 0, L - 1)
            v0r = jnp.clip(uv[:, 1] - uv_bias - anchor[0], 0, L - 1)
            spec_u = kflat[wp * O + sub[:, 0]]   # (Mc, L)
            spec_v = kflat[wp * O + sub[:, 1]]
            Su = spec_u * ramp_tab[u0r]
            Sv = spec_v * ramp_tab[v0r]
        win = window(anchor)
        wspec = jnp.einsum("kr,prc,lc->pkl", Gr, win, Gc,
                           precision=_PRECISION,
                           preferred_element_type=grid.dtype)
        T = jnp.einsum("mk,pkl->pml", Sv, wspec, precision=_PRECISION,
                       preferred_element_type=grid.dtype)
        predicted = jnp.sum(T * Su[None, :, :], axis=-1)  # (P, Mc)
        predicted = predicted * valid[None, :]
        return vis - wt * predicted.T.astype(vis.dtype)

    def group_tapsmm(uv, sub, wp, wt, vis, anchor, valid):
        g, Mc = wp.shape
        u0r = jnp.clip(uv[..., 0] - uv_bias - anchor[:, None, 1], 0, L - 1)
        v0r = jnp.clip(uv[..., 1] - uv_bias - anchor[:, None, 0], 0, L - 1)
        spec_u = kflat[wp * O + sub[..., 0]]
        spec_v = kflat[wp * O + sub[..., 1]]
        Su = spec_u * ramp_tab[u0r]
        Sv = spec_v * ramp_tab[v0r]
        Bu = jnp.matmul(Su.reshape(g * Mc, L), G[:, :ru + K],
                        precision=_PRECISION).reshape(g, Mc, ru + K)
        Bv = jnp.matmul(Sv.reshape(g * Mc, L), G[:, :rv + K],
                        precision=_PRECISION).reshape(g, Mc, rv + K)
        win = jax.vmap(window)(anchor)                    # (g, P, R, C)
        T = jnp.einsum("gmr,gprc->gpmc", Bv, win, precision=_PRECISION,
                       preferred_element_type=grid.dtype)
        predicted = jnp.sum(T * Bu[:, None, :, :], axis=-1)   # (g, P, Mc)
        predicted = predicted * valid[:, None, :]
        return vis - wt * jnp.swapaxes(predicted, 1, 2).astype(vis.dtype)

    def one_tapdict(uv, sub, wp, wt, vis, anchor, valid):
        u0r = jnp.clip(uv[:, 0] - uv_bias - anchor[1], 0, R_off - 1)
        v0r = jnp.clip(uv[:, 1] - uv_bias - anchor[0], 0, R_off - 1)
        Utap = taps_tab[(wp * O + sub[:, 0]) * R_off + u0r][:, :ru + K]
        Vt = taps_tab[(wp * O + sub[:, 1]) * R_off + v0r][:, :rv + K]
        win = window(anchor)
        T = jnp.einsum("mr,prc->pmc", Vt, win, precision=_PRECISION,
                       preferred_element_type=grid.dtype)
        predicted = jnp.sum(T * Utap[None, :, :], axis=-1)  # (P, Mc)
        predicted = predicted * valid[None, :]
        return vis - wt * predicted.T.astype(vis.dtype)

    one = {"fft": one_fft,
           "tapdict": one_tapdict}.get(assembly, one_matmul)
    n_groups = -(-NC // group)
    pad_nc = n_groups * group - NC

    def padg(a):
        return jnp.pad(a, [(0, pad_nc)] + [(0, 0)] * (a.ndim - 1))

    args = tuple(padg(a).reshape((n_groups, group) + a.shape[1:])
                 for a in (plan_uv, plan_sub, plan_wp, plan_wt, plan_vis,
                           plan_anchor, plan_valid))
    if assembly == "tapsmm":
        group_fn = lambda xs: group_tapsmm(*xs)  # noqa: E731
    else:
        group_fn = lambda xs: jax.vmap(one)(*xs)  # noqa: E731
    if n_chunks is None:
        new_vis = jax.lax.map(group_fn, args)
    else:
        ng = jnp.minimum((n_chunks + group - 1) // group,
                         n_groups).astype(jnp.int32)
        vis_groups = args[4]

        def body_at(i, out):
            xsi = tuple(jax.lax.dynamic_index_in_dim(a, i, 0, keepdims=False)
                        for a in args)
            return jax.lax.dynamic_update_index_in_dim(
                out, group_fn(xsi), i, 0)

        new_vis = jax.lax.fori_loop(0, ng, body_at, vis_groups)
    return new_vis.reshape((n_groups * group,) + plan_vis.shape[1:])[:NC]


degrid_chunks = partial(
    jax.jit,
    static_argnames=("pixels", "rv", "ru", "group",
                     "assembly"))(degrid_chunks_impl)


# ---------------------------------------------------------------------------
# Padding-aware grid: the chunk window may extend past the grid edge by up
# to (rv, ru) (anchors are footprint starts, in-range by preprocessing, but
# window size exceeds the remaining extent near the far edges).  Grid with
# a padded array and crop.

def padded_grid_shape(pixels: int, num_pols: int, rv: int, ru: int):
    return (num_pols, pixels + rv, pixels + ru)


class MxuGridder:
    """Stateful convenience wrapper: plan on host, grid/degrid on device.

    Drop-in alternative to the scatter gridder for a (channel, w_slice)
    visibility set whose coordinates are fixed across major cycles (true
    for this pipeline: only vis values change).
    """

    def __init__(self, *, pixels: int, kernel_width: int, num_pols: int,
                 rv: int = 64, ru: int = 64, mc: int = 256,
                 mode: str | None = None):
        if mode is None:
            mode = _MODE[supported_platform()]
        self.pixels = pixels
        self.K = kernel_width
        self.num_pols = num_pols
        # dense mode needs square tiles covering the kernel
        if mode == "dense":
            ts = max(rv, ru, kernel_width)
            rv = ru = ts
        self.rv = rv
        self.ru = ru
        self.mc = mc
        self.mode = mode
        self._tuned = None
        if mode == "dense":
            from . import autotune

            self._tuned = autotune.lookup(
                pixels=pixels, kernel_width=kernel_width,
                num_pols=num_pols, ts=self.rv, mc=mc)

    def plan(self, uv, sub_uv, w_plane, vis, weights) -> ChunkPlan:
        if self.mode == "dense":
            return plan_chunks_tiled(
                np.asarray(uv), np.asarray(sub_uv), np.asarray(w_plane),
                np.asarray(vis), np.asarray(weights), pixels=self.pixels,
                kernel_width=self.K, ts=self.rv, mc=self.mc)
        return plan_chunks(np.asarray(uv), np.asarray(sub_uv),
                           np.asarray(w_plane), np.asarray(vis),
                           np.asarray(weights), pixels=self.pixels,
                           kernel_width=self.K, rv=self.rv, ru=self.ru,
                           mc=self.mc)

    def grid(self, grid, kernel, weights_grid, plan: ChunkPlan,
             vis_chunked=None, dw_chunks=None):
        """Accumulate the planned chunks; ``grid`` is (P, N, N) jnp.
        ``vis_chunked`` overrides the plan's vis payload (same layout);
        ``dw_chunks`` (NC, Mc, P) provides precomputed per-vis density
        weights (skips the random grid gather in the hot path)."""
        if plan.uv.shape[0] == 0:
            return grid
        vis_arr = (jnp.asarray(plan.vis) if vis_chunked is None
                   else vis_chunked)
        if self.mode == "dense":
            ext = dense_pad_size(self.pixels, self.rv)
            gpad = jnp.pad(grid, ((0, 0), (0, ext - self.pixels),
                                  (0, ext - self.pixels)))
            valid = jnp.asarray(plan.valid)
            gpad = grid_chunks_dense(
                gpad, kernel, weights_grid,
                jnp.asarray(plan.uv), jnp.asarray(plan.sub_uv),
                jnp.asarray(plan.w_plane), vis_arr,
                jnp.asarray(plan.anchor), valid,
                dw_chunks, occupied_chunks(valid),
                pixels=self.pixels, ts=self.rv,
                group=(self._tuned or {}).get("group"),
                assembly=(self._tuned or {}).get("assembly",
                                                 default_assembly()))
            return gpad[:, :self.pixels, :self.pixels]
        pad_v, pad_u = self.rv, self.ru
        gpad = jnp.pad(grid, ((0, 0), (0, pad_v), (0, pad_u)))
        args = (gpad, kernel, weights_grid,
                jnp.asarray(plan.uv), jnp.asarray(plan.sub_uv),
                jnp.asarray(plan.w_plane), vis_arr,
                jnp.asarray(plan.anchor), jnp.asarray(plan.valid))
        gpad = grid_chunks(*args, pixels=self.pixels, rv=self.rv,
                           ru=self.ru)
        return gpad[:, :self.pixels, :self.pixels]

    def degrid(self, grid, kernel, plan: ChunkPlan, vis_chunked):
        """Subtract degridded model from chunked vis; returns (C, Mc, P)."""
        pad_v, pad_u = self.rv, self.ru
        gpad = jnp.pad(grid, ((0, 0), (0, pad_v), (0, pad_u)))
        args = (gpad, kernel,
                jnp.asarray(plan.uv), jnp.asarray(plan.sub_uv),
                jnp.asarray(plan.w_plane), jnp.asarray(plan.weights),
                vis_chunked, jnp.asarray(plan.anchor),
                jnp.asarray(plan.valid))
        return degrid_chunks(*args, occupied_chunks(args[-1]),
                             pixels=self.pixels, rv=self.rv,
                             ru=self.ru, assembly=default_assembly())

    def upload_plan(self, plan: ChunkPlan) -> ChunkPlan:
        """Upload the plan's coordinate fields to the device ONCE.

        ``grid``/``degrid``/``chunk_vis`` call ``jnp.asarray`` on these
        fields per invocation — a no-op for device arrays, but a repeated
        multi-MB host upload for numpy plans (the plan is fixed across
        major cycles, so pay it once).  ``vis`` stays host-side (grid and
        degrid take it as ``vis_chunked``)."""
        return plan._replace(
            uv=jnp.asarray(plan.uv), sub_uv=jnp.asarray(plan.sub_uv),
            w_plane=jnp.asarray(plan.w_plane),
            weights=jnp.asarray(plan.weights),
            anchor=jnp.asarray(plan.anchor),
            valid=jnp.asarray(plan.valid),
            row_chunk=jnp.asarray(np.asarray(plan.row_chunk,
                                             np.int32)),
            row_slot=jnp.asarray(np.asarray(plan.row_slot, np.int32)))

    def chunk_vis(self, plan: ChunkPlan, vis):
        """Reorder a flat (N, P) vis array into (C, Mc, P) chunk layout.

        Device arrays stay on device (jnp scatter); numpy stays on host.
        """
        shape = plan.weights.shape   # (NC, Mc, P); vis may be dropped
        if isinstance(vis, jnp.ndarray):
            out = jnp.zeros(shape, jnp.complex64)
            return out.at[jnp.asarray(plan.row_chunk),
                          jnp.asarray(plan.row_slot)].set(vis)
        out = np.zeros(shape, np.complex64)
        out[plan.row_chunk, plan.row_slot] = np.asarray(vis)
        return out

    def unchunk_vis(self, plan: ChunkPlan, vis_chunked, n: int):
        """Inverse of :meth:`chunk_vis` (device in, device out)."""
        del n  # implied by the row mapping (kept for API compatibility)
        if isinstance(vis_chunked, jnp.ndarray):
            return vis_chunked[jnp.asarray(plan.row_chunk),
                               jnp.asarray(plan.row_slot)]
        return np.asarray(vis_chunked)[plan.row_chunk, plan.row_slot]
