"""Sharding tests on the virtual 8-device CPU mesh: shard-invariance of the
multi-channel imaging step (the multi-node coverage the reference lacks,
SURVEY.md §4.9)."""

import jax
import numpy as np
import pytest

from katsdpimager_tpu.parallel import (
    MultiChannelConfig, make_example_batch, make_imaging_step, make_mesh,
)
from katsdpimager_tpu.parallel.multichannel import single_channel_step


def small_cfg(minor=0):
    return MultiChannelConfig(
        pixels=64, num_pols=1, kernel_width=8, oversample=4, w_planes=2,
        w_slices=2, chunks_per_slice=16, chunk_size=32, rv=16, ru=16,
        minor_cycles=minor, patch=17, loop_gain=0.2)


class TestShardInvariance:
    @pytest.mark.parametrize("vis_shards", [1, 2, 4])
    def test_dirty_invariant(self, vis_shards):
        """The residual image must not depend on the mesh factorization."""
        cfg = small_cfg()
        C = 8 // vis_shards  # one channel per chan-shard
        batch = make_example_batch(cfg, C)

        # Unsharded oracle
        fn = single_channel_step(cfg)
        expected = []
        for c in range(C):
            res, _ = fn(batch.kernel[c], batch.taper1d[c],
                        batch.pixel_size[c], batch.mid_w[c], batch.uv[c],
                        batch.sub_uv[c], batch.w_plane[c], batch.anchor[c],
                        batch.valid[c], batch.weights[c], batch.vis[c])
            expected.append(np.asarray(res))
        expected = np.stack(expected)

        mesh = make_mesh(vis_shards=vis_shards)
        step = make_imaging_step(mesh, cfg)
        residual, _model = step(batch)
        # f32 summation order differs between shard factorizations; bound
        # the error relative to the image scale (structural sharding bugs
        # produce O(1) errors, reassociation noise is ~1e-3).
        scale = np.abs(expected).max()
        np.testing.assert_allclose(np.asarray(residual), expected,
                                   rtol=0.02, atol=5e-3 * scale)

    def test_with_clean(self):
        """CLEAN minor cycles run inside the sharded step."""
        cfg = small_cfg(minor=5)
        batch = make_example_batch(cfg, 4)
        mesh = make_mesh(vis_shards=2)
        step = make_imaging_step(mesh, cfg)
        residual, model = step(batch)
        assert residual.shape == (4, 1, 64, 64)
        # CLEAN must have moved some flux into the model
        assert float(np.abs(np.asarray(model)).sum()) > 0

    def test_matches_scatter_gridder(self):
        """The chunked step's dirty image must match a direct scatter-grid
        + FFT computation for one channel."""
        import jax.numpy as jnp

        from katsdpimager_tpu.ops import fourier, gridder

        cfg = small_cfg()
        batch = make_example_batch(cfg, 1)
        fn = single_channel_step(cfg)
        res, _ = fn(batch.kernel[0], batch.taper1d[0], batch.pixel_size[0],
                    batch.mid_w[0], batch.uv[0], batch.sub_uv[0],
                    batch.w_plane[0], batch.anchor[0], batch.valid[0],
                    batch.weights[0], batch.vis[0])

        # Rebuild the same computation with the scatter path
        N = cfg.pixels
        half = N // 2
        valid = np.asarray(batch.valid[0])
        wgrid = np.zeros((1, N, N), np.float32)
        uv = np.asarray(batch.uv[0])
        wts = np.asarray(batch.weights[0]) * valid[..., None]
        for s in range(cfg.w_slices):
            fu = uv[s].reshape(-1, 2)
            fw = wts[s].reshape(-1, 1)
            np.add.at(wgrid[0], (fu[:, 1] + half, fu[:, 0] + half), fw[:, 0])
        density = np.where(wgrid > 0, 1.0 / np.where(wgrid > 0, wgrid, 1), 0.0)

        dirty = jnp.zeros((1, N, N), jnp.float32)
        for s in range(cfg.w_slices):
            mask = valid[s].reshape(-1)
            vis_flat = np.asarray(batch.vis[0][s]).reshape(-1, 1) * mask[:, None]
            grid = gridder.grid_vis(
                jnp.zeros((1, N, N), jnp.complex64),
                batch.kernel[0], jnp.asarray(density),
                jnp.asarray(uv[s].reshape(-1, 2)),
                jnp.asarray(np.asarray(batch.sub_uv[0][s]).reshape(-1, 2)),
                jnp.asarray(np.asarray(batch.w_plane[0][s]).reshape(-1)),
                jnp.asarray(vis_flat), pixels=N)
            dirty = fourier.grid_to_image(
                grid, dirty, batch.taper1d[0], batch.mid_w[0][s],
                batch.pixel_size[0], pixels=N)
        dirty_np = np.asarray(dirty)
        np.testing.assert_allclose(np.asarray(res), dirty_np, rtol=2e-3,
                                   atol=2e-3 * np.abs(dirty_np).max())

    def test_devices_available(self):
        assert jax.device_count() >= 8


class TestMxuFFTUnderMesh:
    def test_step_invariant_to_fft_backend(self, monkeypatch):
        """The sharded imaging step produces the same images whether the
        grid->image transform runs through the XLA FFT custom call or the
        four-step matmul FFT (``KTPU_FFT=mxu``) — validates that path
        under shard_map + psum.  pixels >= 256 so the four-step path actually engages
        (smaller sizes fall back to the XLA FFT)."""
        cfg = MultiChannelConfig(
            pixels=256, num_pols=1, kernel_width=8, oversample=4,
            w_planes=2, w_slices=2, chunks_per_slice=16, chunk_size=32,
            rv=16, ru=16, minor_cycles=0, patch=17, loop_gain=0.2)
        batch = make_example_batch(cfg, 2)
        mesh = make_mesh(vis_shards=4)

        monkeypatch.setenv("KTPU_FFT", "xla")
        res_xla = np.asarray(make_imaging_step(mesh, cfg)(batch)[0])
        monkeypatch.setenv("KTPU_FFT", "mxu")
        res_mxu = np.asarray(make_imaging_step(mesh, cfg)(batch)[0])
        scale = np.abs(res_xla).max()
        # corners amplify FFT rounding differences by 1/taper^2 (see
        # test_accuracy_gate); the interior must agree at f32 level
        q = cfg.pixels // 4
        inner_xla = res_xla[..., q:-q, q:-q]
        inner_mxu = res_mxu[..., q:-q, q:-q]
        np.testing.assert_allclose(inner_mxu, inner_xla,
                                   atol=2e-6 * scale)
        np.testing.assert_allclose(res_mxu, res_xla, atol=5e-3 * scale)


def test_batched_slices_matches_scan(monkeypatch):
    """KTPU_BATCH_SLICES=1 (one batched FFT over all W slices) must
    reproduce the per-slice scan path."""
    cfg = MultiChannelConfig(
        pixels=64, num_pols=1, kernel_width=8, oversample=4, w_planes=2,
        w_slices=3, chunks_per_slice=16, chunk_size=32, rv=16, ru=16,
        minor_cycles=0, patch=17, loop_gain=0.2)
    batch = make_example_batch(cfg, 4)
    mesh = make_mesh(vis_shards=2)
    monkeypatch.setenv("KTPU_BATCH_SLICES", "0")
    res_scan = np.asarray(make_imaging_step(mesh, cfg)(batch)[0])
    monkeypatch.setenv("KTPU_BATCH_SLICES", "1")
    res_batch = np.asarray(make_imaging_step(mesh, cfg)(batch)[0])
    scale = np.abs(res_scan).max()
    np.testing.assert_allclose(res_batch, res_scan, atol=1e-5 * scale)


@pytest.mark.parametrize("batch_slices", ["0", "1"])
def test_empty_slice_skip_is_bitwise_neutral(monkeypatch, batch_slices):
    """A completely empty w-slice must not change the result at all: the
    slice body is skipped via lax.cond (scan path) or contributes an
    exactly-zero grid (batched path), so appending an empty slice to a
    batch reproduces the 2-slice result bitwise."""
    monkeypatch.setenv("KTPU_BATCH_SLICES", batch_slices)

    def cfg_with(w_slices):
        return MultiChannelConfig(
            pixels=64, num_pols=1, kernel_width=8, oversample=4,
            w_planes=2, w_slices=w_slices, chunks_per_slice=16,
            chunk_size=32, rv=16, ru=16, minor_cycles=0, patch=17,
            loop_gain=0.2)

    from katsdpimager_tpu.parallel.multichannel import ChannelBatch

    cfg2 = cfg_with(2)
    batch2 = make_example_batch(cfg2, 4)

    def extend(x, fill=0):
        """Append an empty slice along the S axis (axis 1)."""
        a = np.asarray(x)
        pad = np.full((a.shape[0], 1) + a.shape[2:], fill, a.dtype)
        return np.concatenate([a, pad], axis=1)

    batch3 = ChannelBatch(
        kernel=batch2.kernel, taper1d=batch2.taper1d,
        pixel_size=batch2.pixel_size,
        mid_w=extend(batch2.mid_w, fill=1.0),
        uv=extend(batch2.uv), sub_uv=extend(batch2.sub_uv),
        w_plane=extend(batch2.w_plane), anchor=extend(batch2.anchor),
        valid=extend(batch2.valid), weights=extend(batch2.weights),
        vis=extend(batch2.vis))

    mesh = make_mesh(vis_shards=2)
    res2 = np.asarray(make_imaging_step(mesh, cfg2)(batch2)[0])
    res3 = np.asarray(make_imaging_step(mesh, cfg_with(3))(batch3)[0])
    assert np.array_equal(res3, res2)
