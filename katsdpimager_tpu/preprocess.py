r"""Visibility preprocessing: polarization conversion, weighting, quantization
and compression.

Behavioural parity with the reference's C++ collector
(``preprocess.py`` + ``preprocess.cpp``):

- per-visibility Mueller-matrix polarization conversion, optionally with
  parallactic/feed-angle rotation applied in the circular frame
  (preprocess.cpp:198-242);
- statistical weights propagated through the Mueller matrix as variances
  with 0·inf = 0 semantics (preprocess.cpp:450-470, mulz.h);
- visibilities with any zero input weight discarded; non-finite results
  squashed to zero weight (preprocess.cpp:445-453,487-493);
- w < 0 flipped to +w with conjugated visibilities (preprocess.cpp:475-482);
- UV quantized to (int16 cell, int16 subpixel) at ``oversample`` subcells,
  w to (w_slice, w_plane) with the first slice half-width
  (preprocess.cpp:496-507);
- identically-quantized visibilities merged ("compression"), bucketed by
  (channel, w_slice).

The jitted JAX engine differs in *how*: instead of an OpenMP loop plus an
adjacent-merge pass, the whole batch is transformed vectorized under jit,
sorted by a packed 62-bit key and merged with a segment-sum — which merges
*all* duplicates in a buffer, not just adjacent ones, so compression is at
least as strong as the reference for the same buffer size.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from functools import partial
from typing import List, Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp


# -----------------------------------------------------------------------------
# Static per-channel geometry for quantization


@dataclasses.dataclass(frozen=True)
class ChannelGeometry:
    """Static quantization geometry for one channel (all floats in metres)."""

    pixels: int
    cell_size: float
    oversample: int
    w_slices: int
    w_planes: int
    max_w: float
    kernel_width: int

    def __post_init__(self):
        # Bit budget of the packed sort key (see _pack_key).
        assert self.pixels <= 32768
        assert self.oversample <= 128
        assert self.w_planes <= 1024
        assert self.w_slices <= 128

    @classmethod
    def from_parameters(cls, image_p, grid_p) -> "ChannelGeometry":
        return cls(
            pixels=image_p.pixels,
            cell_size=image_p.cell_size,
            oversample=grid_p.fixed.oversample,
            w_slices=grid_p.w_slices,
            w_planes=grid_p.w_planes,
            max_w=grid_p.fixed.max_w,
            kernel_width=grid_p.fixed.kernel_width,
        )


def apply_mueller_weights(vis, weights, mueller):
    """Convert correlation products with a Mueller matrix and propagate
    weights as variances with 0*inf = 0 semantics.

    vis: (N, Q) complex; weights: (N, Q) float; mueller: (P, Q) or (N, P, Q).
    Returns (xvis (N, P) complex, xweights (N, P) float).
    """
    if mueller.ndim == 2:
        xvis = jnp.einsum("pq,nq->np", mueller, vis, precision="highest")
        m2 = jnp.abs(mueller) ** 2  # (P, Q)
        inv_w = 1.0 / jnp.abs(weights)  # inf where weight == 0
        # 0 * inf -> 0: only accumulate variance through non-zero couplings.
        contrib = jnp.where(m2[None] > 0, m2[None] * inv_w[:, None, :], 0.0)
        var = jnp.sum(contrib, axis=-1)
    else:
        xvis = jnp.einsum("npq,nq->np", mueller, vis, precision="highest")
        m2 = jnp.abs(mueller) ** 2  # (N, P, Q)
        inv_w = 1.0 / jnp.abs(weights)
        contrib = jnp.where(m2 > 0, m2 * inv_w[:, None, :], 0.0)
        var = jnp.sum(contrib, axis=-1)
    xweights = 1.0 / var
    return xvis, xweights


def rotated_mueller_np(from_circular, to_circular, feed_angle1, feed_angle2):
    """Numpy version of :func:`rotated_mueller` (host data plane)."""
    r1 = np.exp(1j * np.asarray(feed_angle1, np.float32))
    r2 = np.exp(1j * np.asarray(feed_angle2, np.float32))
    rr = r1 * np.conj(r2)
    rl = r1 * r2
    diag = np.stack([rr, rl, np.conj(rl), np.conj(rr)], axis=-1)
    mid = np.asarray(to_circular)[None, :, :] * diag[:, :, None]
    return np.einsum("pc,ncq->npq", np.asarray(from_circular), mid)


def rotated_mueller(from_circular, to_circular, feed_angle1, feed_angle2):
    """Per-visibility Mueller matrices with feed-angle rotation.

    The rotation is diagonal in the circular frame: RR scales by
    ``e^{i(a1-a2)}``, RL by ``e^{i(a1+a2)}``, LR/LL by the conjugates
    (reference preprocess.cpp:229-242).
    """
    r1 = jnp.exp(1j * feed_angle1.astype(jnp.float32))
    r2 = jnp.exp(1j * feed_angle2.astype(jnp.float32))
    rr = r1 * jnp.conj(r2)
    rl = r1 * r2
    diag = jnp.stack([rr, rl, jnp.conj(rl), jnp.conj(rr)], axis=-1)  # (N, 4)
    mid = to_circular[None, :, :] * diag[:, :, None]  # (N, 4, Q)
    return jnp.einsum("pc,ncq->npq", from_circular, mid, precision="highest")


def _pack_keys(uv, sub_uv, w_plane, w_slice, invalid):
    """Pack quantized coordinates into three int32 lexicographic sort keys
    (most-significant first).  int64 is avoided to keep the sort cheap
    and x64 mode disabled.  Records compare equal exactly when all
    quantized coordinates match; invalid records sort last.
    """
    i32 = lambda x: x.astype(jnp.int32)
    # k2 (primary): invalid(1) | w_slice(7)
    k2 = (i32(invalid) << 7) | i32(w_slice)
    # k1: v(15) | u(15), biased to non-negative
    k1 = ((i32(uv[:, 1]) + 16384) << 15) | (i32(uv[:, 0]) + 16384)
    # k0 (least significant): sub_v(7) | sub_u(7) | w_plane(10)
    k0 = (((i32(sub_uv[:, 1]) << 7) | i32(sub_uv[:, 0])) << 10) | i32(w_plane)
    return k0, k1, k2


@partial(jax.jit, static_argnames=("geometry", "num_pols"))
def _preprocess_channel(geometry: ChannelGeometry, num_pols: int,
                        uvw, weights, vis, mueller):
    """Transform + quantize + sort + merge one channel's batch.

    Returns a dict of padded arrays (length N) plus ``count`` (merged
    records) and per-slice ``slice_counts``.
    """
    N = uvw.shape[0]
    uvw = uvw.astype(jnp.float32)

    # Flagged if any input polarization has zero weight (preprocess.cpp:445).
    flagged = jnp.any(weights == 0.0, axis=-1)

    xvis, xweights = apply_mueller_weights(vis, weights, mueller)

    # Flip to w >= 0 (conjugate symmetry of the visibility function).
    flip = uvw[:, 2] < 0
    uvw = jnp.where(flip[:, None], -uvw, uvw)
    xvis = jnp.where(flip[:, None], jnp.conj(xvis), xvis)

    # Pre-multiply weights; squash non-finite products (NaN inputs etc.).
    wvis = xvis * xweights
    bad = ~(jnp.isfinite(wvis.real) & jnp.isfinite(wvis.imag))
    wvis = jnp.where(bad, 0.0, wvis)
    xweights = jnp.where(bad, 0.0, xweights)

    # UV quantization: cell + subpixel at `oversample` subcells.
    uv_scale = jnp.float32(1.0 / geometry.cell_size)
    xs = jnp.floor(uvw[:, :2] * uv_scale * geometry.oversample).astype(jnp.int32)
    uv = xs // geometry.oversample
    sub_uv = xs - uv * geometry.oversample

    # W quantization: first slice half-width, centred at w = 0.
    w_scale = jnp.float32(
        (geometry.w_slices - 0.5) * geometry.w_planes / geometry.max_w
    )
    max_slice_plane = geometry.w_slices * geometry.w_planes - 1
    wq = jnp.trunc(uvw[:, 2] * w_scale + geometry.w_planes * 0.5).astype(jnp.int32)
    wq = jnp.clip(wq, 0, max_slice_plane)
    w_plane = wq % geometry.w_planes
    w_slice = wq // geometry.w_planes

    # The gridder needs the whole kernel footprint inside the grid:
    # index0 = uv + pixels//2 - (ksize-1)//2 must give [0, pixels) coverage.
    idx0 = uv + geometry.pixels // 2 - (geometry.kernel_width - 1) // 2
    in_range = jnp.all(
        (idx0 >= 0) & (idx0 + geometry.kernel_width <= geometry.pixels), axis=-1
    )

    invalid = flagged | ~in_range | jnp.all(xweights == 0.0, axis=-1)

    k0, k1, k2 = _pack_keys(uv, sub_uv, w_plane, w_slice, invalid)
    order = jnp.lexsort((k0, k1, k2))
    k0, k1, k2 = k0[order], k1[order], k2[order]

    uv_s = uv[order]
    sub_s = sub_uv[order]
    wp_s = w_plane[order]
    ws_s = w_slice[order]
    vis_s = wvis[order]
    wt_s = xweights[order]
    inv_s = invalid[order]

    # Merge runs of identical keys with a segment sum.
    same = (k0[1:] == k0[:-1]) & (k1[1:] == k1[:-1]) & (k2[1:] == k2[:-1])
    new_seg = jnp.concatenate([jnp.ones((1,), jnp.int32),
                               (~same).astype(jnp.int32)])
    seg_id = jnp.cumsum(new_seg) - 1
    merged_vis = jax.ops.segment_sum(vis_s, seg_id, num_segments=N)
    merged_wt = jax.ops.segment_sum(wt_s, seg_id, num_segments=N)
    first = new_seg.astype(bool)
    seg_src = jnp.where(first, jnp.arange(N), 0)
    starts = jax.ops.segment_max(seg_src, seg_id, num_segments=N)

    num_segments = seg_id[-1] + 1
    valid_count = jnp.sum(~inv_s[starts] & (jnp.arange(N) < num_segments))

    out_uv = uv_s[starts].astype(jnp.int16)
    out_sub = sub_s[starts].astype(jnp.int16)
    out_wp = wp_s[starts].astype(jnp.int16)
    out_ws = ws_s[starts].astype(jnp.int16)
    out_invalid = inv_s[starts] | (jnp.arange(N) >= num_segments)

    # Zero out padding so downstream segment sums are unaffected.
    merged_vis = jnp.where(out_invalid[:, None], 0.0, merged_vis)
    merged_wt = jnp.where(out_invalid[:, None], 0.0, merged_wt)
    out_ws = jnp.where(out_invalid, jnp.int16(geometry.w_slices), out_ws)

    slice_counts = jax.ops.segment_sum(
        jnp.ones((N,), jnp.int32) * (~out_invalid),
        out_ws.astype(jnp.int32),
        num_segments=geometry.w_slices + 1,
    )[: geometry.w_slices]

    return {
        "uv": out_uv,
        "sub_uv": out_sub,
        "w_plane": out_wp,
        "w_slice": out_ws,
        "weights": merged_wt.astype(jnp.float32),
        "vis": merged_vis.astype(jnp.complex64),
        "count": valid_count,
        "slice_counts": slice_counts,
    }


# -----------------------------------------------------------------------------
# Collector / reader (host-side streaming orchestration)


class VisibilityCollector:
    """Streams raw visibility chunks through the jitted preprocessor and
    stores compressed records bucketed by (channel, w_slice).

    API parity with the reference collector (``preprocess.py:73-288``):
    ``add(...)`` per chunk, ``close()``, then ``reader()``.
    """

    def __init__(self, image_parameters: Sequence, grid_parameters: Sequence,
                 buffer_size: int = 1 << 20, engine: str = "jax"):
        if engine not in ("jax", "native"):
            raise ValueError(f"Unknown preprocess engine {engine!r}")
        if len(image_parameters) != len(grid_parameters):
            raise ValueError("Inconsistent image/grid parameter lengths")
        self.image_parameters = list(image_parameters)
        self.grid_parameters = list(grid_parameters)
        self.geometries = [
            ChannelGeometry.from_parameters(ip, gp)
            for ip, gp in zip(image_parameters, grid_parameters)
        ]
        self.num_pols = image_parameters[0].fixed.num_polarizations
        self.buffer_size = buffer_size
        self.num_input = 0
        self.num_output = 0
        # buckets[channel][w_slice] -> list of record dicts (numpy)
        self._buckets: List[List[List[dict]]] = [
            [[] for _ in range(gp.w_slices)] for gp in self.grid_parameters
        ]
        self._closed = False
        self.engine = engine

    @property
    def num_channels(self):
        return len(self.image_parameters)

    def add(self, uvw, weights, vis, feed_angle1=None, feed_angle2=None,
            mueller_stokes=None, mueller_circular=None):
        """Add a chunk of raw visibilities.

        uvw: (N, 3) float metres. weights/vis: (C, N, Q). If
        ``mueller_circular`` is given, per-visibility feed-angle rotation is
        applied via the circular frame (``mueller_stokes`` maps circular ->
        output Stokes); otherwise ``mueller_stokes`` maps inputs directly.
        """
        if self.engine == "native":
            return self._add_native(uvw, weights, vis, feed_angle1,
                                    feed_angle2, mueller_stokes,
                                    mueller_circular)
        uvw = np.asarray(uvw, np.float32)
        N = uvw.shape[0]
        if mueller_circular is not None:
            mueller_dev = rotated_mueller(
                jnp.asarray(np.asarray(mueller_stokes)),
                jnp.asarray(np.asarray(mueller_circular)),
                jnp.asarray(np.asarray(feed_angle1, np.float32)),
                jnp.asarray(np.asarray(feed_angle2, np.float32)))
        else:
            mueller_dev = jnp.asarray(np.asarray(mueller_stokes))
        for channel in range(self.num_channels):
            out = _preprocess_channel(
                self.geometries[channel], self.num_pols,
                jnp.asarray(uvw), jnp.asarray(weights[channel]),
                jnp.asarray(np.asarray(vis[channel])), mueller_dev)
            out = jax.device_get(out)
            self._store(channel, out)
            self.num_input += N
            self.num_output += int(out["count"])

    def _add_native(self, uvw, weights, vis, feed_angle1, feed_angle2,
                    mueller_stokes, mueller_circular):
        """Host-side compute path: the C++/OpenMP core (all cores; the
        role preprocess.cpp plays in the reference).  Keeps the
        accelerator free for imaging waves — the cube pipeline's default
        when a non-CPU backend is active."""
        from . import native

        uvw = np.ascontiguousarray(uvw, np.float32)
        N = uvw.shape[0]
        if mueller_circular is not None:
            mueller = rotated_mueller_np(mueller_stokes, mueller_circular,
                                         feed_angle1, feed_angle2)
        else:
            mueller = np.asarray(mueller_stokes)
        for channel in range(self.num_channels):
            out = native.preprocess_channel(
                uvw, np.asarray(weights[channel]), np.asarray(vis[channel]),
                mueller, self.geometries[channel])
            self._store(channel, out)
            self.num_input += N
            self.num_output += int(out["count"])

    def _store(self, channel: int, out: dict):
        # Records are sorted by w_slice; slice s occupies
        # [start, start+counts[s]) among valid records.  The JAX path
        # also returns the per-record w_slice; the native path derives
        # everything from the counts (checked against count at source).
        ws = out.get("w_slice")
        counts = out["slice_counts"]
        start = 0
        for s in range(self.grid_parameters[channel].w_slices):
            n = int(counts[s])
            if n == 0:
                continue
            sl = slice(start, start + n)
            assert ws is None or np.all(ws[sl] == s)
            self._buckets[channel][s].append({
                "uv": out["uv"][sl].copy(),
                "sub_uv": out["sub_uv"][sl].copy(),
                "w_plane": out["w_plane"][sl].copy(),
                "weights": out["weights"][sl].copy(),
                "vis": out["vis"][sl].copy(),
            })
            start += n

    def close(self):
        self._closed = True

    def reader(self) -> "VisibilityReader":
        return VisibilityReader(self)


@dataclasses.dataclass
class VisChunk:
    """One block of compressed visibilities for a (channel, w_slice)."""

    uv: np.ndarray        # (N, 2) int16, centred
    sub_uv: np.ndarray    # (N, 2) int16
    w_plane: np.ndarray   # (N,) int16
    weights: np.ndarray   # (N, P) float32
    vis: np.ndarray       # (N, P) complex64

    def __len__(self):
        return len(self.uv)

    def __getitem__(self, field):
        return getattr(self, field)


class VisibilityReader:
    """Iterates compressed visibilities per (channel, w_slice).

    API parity with reference ``preprocess.py:291-421``.
    """

    def __init__(self, collector: VisibilityCollector):
        self._collector = collector

    def num_w_slices(self, channel: int) -> int:
        return self._collector.grid_parameters[channel].w_slices

    def len(self, channel: int, w_slice: int) -> int:
        return sum(len(b["uv"]) for b in self._collector._buckets[channel][w_slice])

    def slice_arrays(self, channel: int, w_slice: int) -> VisChunk:
        """All records for a slice as one contiguous chunk."""
        bs = self._collector._buckets[channel][w_slice]
        if not bs:
            z = np.zeros
            P = self._collector.num_pols
            return VisChunk(z((0, 2), np.int16), z((0, 2), np.int16),
                            z((0,), np.int16), z((0, P), np.float32),
                            z((0, P), np.complex64))
        return VisChunk(
            np.concatenate([b["uv"] for b in bs]),
            np.concatenate([b["sub_uv"] for b in bs]),
            np.concatenate([b["w_plane"] for b in bs]),
            np.concatenate([b["weights"] for b in bs]),
            np.concatenate([b["vis"] for b in bs]),
        )

    def slice_coords(self, channel: int, w_slice: int):
        """(uv, sub_uv, w_plane) only — for planning passes that do not
        need payloads (spares the vis/weights read on spill backends)."""
        c = self.slice_arrays(channel, w_slice)
        return c.uv, c.sub_uv, c.w_plane

    def iter_slice(self, channel: int, w_slice: int, block_size: Optional[int] = None):
        arrays = self.slice_arrays(channel, w_slice)
        n = len(arrays)
        if block_size is None or block_size >= n:
            if n:
                yield arrays
            return
        for start in range(0, n, block_size):
            sl = slice(start, start + block_size)
            yield VisChunk(arrays.uv[sl], arrays.sub_uv[sl], arrays.w_plane[sl],
                           arrays.weights[sl], arrays.vis[sl])

    def close(self):
        pass


class VisibilityCollectorMem(VisibilityCollector):
    """In-memory backend (parity alias; the base class is already in-memory)."""


class VisibilityCollectorNative(VisibilityCollector):
    """Collector computing on the C++/OpenMP core (``engine="native"``
    alias, kept for API parity)."""

    def __init__(self, *args, **kwargs):
        kwargs["engine"] = "native"
        super().__init__(*args, **kwargs)


class VisibilityCollectorSpill(VisibilityCollector):
    """Disk-spill backend: each (channel, w_slice) bucket is appended to
    raw per-field files in ``dirname``, so host RAM stays bounded for large
    cubes (the reference spills to HDF5, ``preprocess.py:169-265``; plain
    files need no h5py).  The reader memory-maps them."""

    def __init__(self, dirname, image_parameters, grid_parameters,
                 buffer_size: int = 1 << 20, engine: str = "jax"):
        super().__init__(image_parameters, grid_parameters, buffer_size,
                         engine=engine)
        os.makedirs(dirname, exist_ok=True)
        self.dirname = dirname
        P = self.num_pols
        #: field -> (dtype, per-record shape)
        self.fields = {"uv": (np.int16, (2,)), "sub_uv": (np.int16, (2,)),
                       "w_plane": (np.int16, ()),
                       "weights": (np.float32, (P,)),
                       "vis": (np.complex64, (P,))}
        self.counts = {}   # (channel, w_slice) -> records written

    def path(self, channel: int, w_slice: int, field: str) -> str:
        return os.path.join(self.dirname, f"ch{channel}_ws{w_slice}.{field}")

    def _store(self, channel, out):
        counts = out["slice_counts"]
        start = 0
        for s in range(self.grid_parameters[channel].w_slices):
            n = int(counts[s])
            if n == 0:
                continue
            sl = slice(start, start + n)
            for name, (dtype, _tail) in self.fields.items():
                with open(self.path(channel, s, name), "ab") as f:
                    f.write(np.ascontiguousarray(out[name][sl], dtype)
                            .tobytes())
            self.counts[channel, s] = self.counts.get((channel, s), 0) + n
            start += n

    def reader(self):
        return VisibilityReaderSpill(self)


class VisibilityReaderSpill(VisibilityReader):
    def _field(self, channel, w_slice, name):
        c = self._collector
        dtype, tail = c.fields[name]
        return np.memmap(c.path(channel, w_slice, name), dtype, mode="r",
                         shape=(self.len(channel, w_slice),) + tail)

    def _empty(self):
        P = self._collector.num_pols
        z = np.zeros
        return VisChunk(z((0, 2), np.int16), z((0, 2), np.int16),
                        z((0,), np.int16), z((0, P), np.float32),
                        z((0, P), np.complex64))

    def len(self, channel, w_slice):
        return self._collector.counts.get((channel, w_slice), 0)

    def slice_arrays(self, channel, w_slice):
        if self.len(channel, w_slice) == 0:
            return self._empty()
        return VisChunk(*(np.array(self._field(channel, w_slice, name))
                          for name in self._collector.fields))

    def slice_coords(self, channel, w_slice):
        """Read only the coordinate files (planning passes skip the
        vis/weights payload — ~80% of the slice bytes at P=4)."""
        if self.len(channel, w_slice) == 0:
            e = self._empty()
            return e.uv, e.sub_uv, e.w_plane
        return tuple(np.array(self._field(channel, w_slice, name))
                     for name in ("uv", "sub_uv", "w_plane"))

    def iter_slice(self, channel, w_slice, block_size=None):
        """Stream blocks of at most ``block_size`` records, read from the
        memory-mapped files on demand (parity with reference
        preprocess.py:341-377)."""
        n = self.len(channel, w_slice)
        if n == 0:
            return
        if block_size is None or block_size >= n:
            yield self.slice_arrays(channel, w_slice)
            return
        maps = [self._field(channel, w_slice, name)
                for name in self._collector.fields]
        for start in range(0, n, block_size):
            sl = slice(start, min(n, start + block_size))
            yield VisChunk(*(np.array(m[sl]) for m in maps))

    def close(self):
        shutil.rmtree(self._collector.dirname, ignore_errors=True)
