"""Tests for visibility preprocessing: Mueller/weight transforms,
quantization, w-flip, compression (strategy mirrors reference
test_preprocess.py hand-computed expectations)."""

import numpy as np
import pytest

from katsdpimager_tpu import parameters, polarization, preprocess


def make_params(pixels=1024, cell_size=10.0, oversample=8, w_slices=4,
                w_planes=8, max_w=1000.0, pols=(polarization.STOKES_I,)):
    fixed = parameters.FixedImageParameters(tuple(pols))
    wavelength = 0.21
    pixel_size = wavelength / (cell_size * pixels)
    ip = parameters.ImageParameters(fixed, wavelength, pixel_size, pixels)
    fgp = parameters.FixedGridParameters(
        antialias_width=7.0, oversample=oversample, image_oversample=4,
        max_w=max_w, kernel_width=16)
    gp = parameters.GridParameters(fgp, w_slices, w_planes)
    assert ip.cell_size == pytest.approx(cell_size)
    return ip, gp


def collect(uvw, weights, vis, mueller, ip, gp):
    c = preprocess.VisibilityCollectorMem([ip], [gp])
    c.add(uvw, weights, vis, mueller_stokes=mueller)
    c.close()
    return c


class TestQuantization:
    def test_basic_coordinates(self):
        ip, gp = make_params()
        # u = 34.3 cells -> xs = floor(34.3*8)=274 -> cell 34, sub 2
        uvw = np.array([[343.0, -127.5, 100.0]], np.float32)
        vis = np.array([[[1 + 2j]]], np.complex64)
        weights = np.array([[[2.0]]], np.float32)
        mueller = np.eye(1, dtype=np.complex64)
        c = collect(uvw, weights, vis, mueller, ip, gp)
        r = c.reader()
        # w quantization: w_scale = 3.5*8/1000 = 0.028
        # 100*0.028 + 4 = 6.8 -> plane 6 -> slice 0, w_plane 6
        assert r.len(0, 0) == 1
        chunk = r.slice_arrays(0, 0)
        np.testing.assert_array_equal(chunk.uv[0], [34, -13])
        # v: -12.75 cells -> floor(-12.75*8) = -102 -> cell -13, sub 2
        np.testing.assert_array_equal(chunk.sub_uv[0], [2, 2])
        assert chunk.w_plane[0] == 6
        np.testing.assert_allclose(chunk.weights[0], [2.0])
        np.testing.assert_allclose(chunk.vis[0], [2 + 4j])  # pre-weighted

    def test_w_flip_conjugates(self):
        ip, gp = make_params()
        uvw = np.array([[343.0, -127.5, -100.0]], np.float32)
        vis = np.array([[[1 + 2j]]], np.complex64)
        weights = np.array([[[1.0]]], np.float32)
        mueller = np.eye(1, dtype=np.complex64)
        c = collect(uvw, weights, vis, mueller, ip, gp)
        chunk = c.reader().slice_arrays(0, 0)
        np.testing.assert_array_equal(chunk.uv[0], [-35, 12])
        # -u = -34.3 cells -> floor(-274.4) = -275 -> cell -35, sub 5
        # -v = 12.75 cells -> floor(102.0) = 102 -> cell 12, sub 6
        np.testing.assert_array_equal(chunk.sub_uv[0], [5, 6])
        np.testing.assert_allclose(chunk.vis[0], [1 - 2j])

    def test_w_slice_assignment(self):
        ip, gp = make_params()  # w_scale = 0.028, first slice half width
        mueller = np.eye(1, dtype=np.complex64)
        # slice boundaries in w: plane index = trunc(w*0.028 + 4)
        # slice 0: planes 0-7 -> w < (8-4)/0.028 = 142.86
        # slice 3: planes 24-31, clipped at 31
        for w, expected_slice in [(10.0, 0), (142.0, 0), (143.0, 1),
                                  (950.0, 3), (5000.0, 3)]:
            uvw = np.array([[10.0, 10.0, w]], np.float32)
            c = collect(uvw, np.ones((1, 1, 1), np.float32),
                        np.ones((1, 1, 1), np.complex64), mueller, ip, gp)
            r = c.reader()
            lens = [r.len(0, s) for s in range(4)]
            assert lens[expected_slice] == 1, (w, lens)

    def test_flagged_dropped(self):
        ip, gp = make_params()
        uvw = np.array([[10.0, 10.0, 1.0], [20.0, 20.0, 1.0]], np.float32)
        vis = np.ones((1, 2, 1), np.complex64)
        weights = np.array([[[0.0], [1.0]]], np.float32)
        mueller = np.eye(1, dtype=np.complex64)
        c = collect(uvw, weights, vis, mueller, ip, gp)
        assert c.num_output == 1

    def test_nan_squashed(self):
        ip, gp = make_params()
        uvw = np.array([[10.0, 10.0, 1.0]], np.float32)
        vis = np.array([[[np.nan + 1j]]], np.complex64)
        weights = np.ones((1, 1, 1), np.float32)
        mueller = np.eye(1, dtype=np.complex64)
        c = collect(uvw, weights, vis, mueller, ip, gp)
        # squashed to zero vis and weight -> all weights zero -> dropped
        assert c.num_output == 0

    def test_merging(self):
        ip, gp = make_params()
        # Two identical quantized coords (even non-adjacent), one different
        uvw = np.array([[343.0, 100.0, 10.0],
                        [50.0, 50.0, 10.0],
                        [343.02, 100.01, 10.0]], np.float32)
        vis = np.array([[[1 + 1j], [5 + 0j], [2 - 1j]]], np.complex64)
        weights = np.array([[[1.0], [1.0], [3.0]]], np.float32)
        mueller = np.eye(1, dtype=np.complex64)
        c = collect(uvw, weights, vis, mueller, ip, gp)
        assert c.num_output == 2
        chunk = c.reader().slice_arrays(0, 0)
        # find the merged record
        i = int(np.nonzero(chunk.uv[:, 0] == 34)[0][0])
        np.testing.assert_allclose(chunk.weights[i], [4.0])
        np.testing.assert_allclose(chunk.vis[i], [(1 + 1j) + 3 * (2 - 1j)])

    def test_out_of_range_dropped(self):
        ip, gp = make_params()
        # uv beyond grid edge: pixels=1024, kernel 16 -> |uv| < ~504
        uvw = np.array([[10000.0, 0.0, 1.0]], np.float32)
        c = collect(uvw, np.ones((1, 1, 1), np.float32),
                    np.ones((1, 1, 1), np.complex64),
                    np.eye(1, dtype=np.complex64), ip, gp)
        assert c.num_output == 0


class TestMueller:
    def test_stokes_i_from_linear(self):
        ip, gp = make_params()
        mueller = polarization.polarization_matrix(
            [polarization.STOKES_I],
            [polarization.STOKES_XX, polarization.STOKES_YY])
        uvw = np.array([[10.0, 10.0, 1.0]], np.float32)
        vis = np.array([[[2 + 0j, 4 + 0j]]], np.complex64)  # XX, YY
        weights = np.array([[[1.0, 1.0]]], np.float32)
        c = collect(uvw, weights, vis, mueller, ip, gp)
        chunk = c.reader().slice_arrays(0, 0)
        # I = (XX+YY)/2 = 3; variance = 0.25*(1/1) + 0.25*(1/1) = 0.5 -> w=2
        np.testing.assert_allclose(chunk.weights[0], [2.0], rtol=1e-6)
        np.testing.assert_allclose(chunk.vis[0], [6.0], rtol=1e-6)  # 3 * w

    def test_weight_variance_propagation(self):
        ip, gp = make_params()
        mueller = polarization.polarization_matrix(
            [polarization.STOKES_I],
            [polarization.STOKES_XX, polarization.STOKES_YY])
        uvw = np.array([[10.0, 10.0, 1.0]], np.float32)
        vis = np.ones((1, 1, 2), np.complex64)
        weights = np.array([[[2.0, 4.0]]], np.float32)
        c = collect(uvw, weights, vis, mueller, ip, gp)
        chunk = c.reader().slice_arrays(0, 0)
        # var = 0.25/2 + 0.25/4 = 0.1875 -> weight = 16/3
        np.testing.assert_allclose(chunk.weights[0], [16 / 3], rtol=1e-6)

    def test_parallactic_rotation_identity_at_zero(self):
        ip, gp = make_params()
        from_circ, to_circ = polarization.polarization_matrices(
            [polarization.STOKES_I],
            [polarization.STOKES_XX, polarization.STOKES_XY,
             polarization.STOKES_YX, polarization.STOKES_YY])
        uvw = np.array([[10.0, 10.0, 1.0]], np.float32)
        vis = np.array([[[2 + 0j, 1j, -1j, 4 + 0j]]], np.complex64)
        weights = np.ones((1, 1, 4), np.float32)

        c1 = preprocess.VisibilityCollectorMem([ip], [gp])
        c1.add(uvw, weights, vis, feed_angle1=np.zeros(1, np.float32),
               feed_angle2=np.zeros(1, np.float32),
               mueller_stokes=from_circ, mueller_circular=to_circ)
        chunk1 = c1.reader().slice_arrays(0, 0)

        direct = polarization.polarization_matrix(
            [polarization.STOKES_I],
            [polarization.STOKES_XX, polarization.STOKES_XY,
             polarization.STOKES_YX, polarization.STOKES_YY])
        c2 = preprocess.VisibilityCollectorMem([ip], [gp])
        c2.add(uvw, weights, vis, mueller_stokes=direct)
        chunk2 = c2.reader().slice_arrays(0, 0)
        np.testing.assert_allclose(chunk1.vis, chunk2.vis, atol=1e-5)
        np.testing.assert_allclose(chunk1.weights, chunk2.weights, rtol=1e-5)


class TestHDF5Backend:
    def test_roundtrip(self, tmp_path):
        ip, gp = make_params()
        uvw = np.random.RandomState(1).uniform(-500, 500, (100, 3)).astype(np.float32) * 10
        vis = (np.random.RandomState(2).normal(size=(1, 100, 1))
               + 1j * np.random.RandomState(3).normal(size=(1, 100, 1))).astype(np.complex64)
        weights = np.ones((1, 100, 1), np.float32)
        mueller = np.eye(1, dtype=np.complex64)

        cmem = collect(uvw, weights, vis, mueller, ip, gp)
        ch5 = preprocess.VisibilityCollectorSpill(
            str(tmp_path / "vis"), [ip], [gp])
        ch5.add(uvw, weights, vis, mueller_stokes=mueller)
        ch5.close()

        rm, rh = cmem.reader(), ch5.reader()
        for s in range(gp.w_slices):
            assert rm.len(0, s) == rh.len(0, s)
            a, b = rm.slice_arrays(0, s), rh.slice_arrays(0, s)
            np.testing.assert_array_equal(a.uv, b.uv)
            np.testing.assert_allclose(a.vis, b.vis)
        rh.close()

    def test_iter_slice_streams_blocks(self, tmp_path):
        """Block-streamed read-back equals the one-shot
        slice; coordinate-only reads match too."""
        ip, gp = make_params()
        rng = np.random.RandomState(7)
        uvw = rng.uniform(-500, 500, (300, 3)).astype(np.float32) * 10
        vis = (rng.normal(size=(1, 300, 1))
               + 1j * rng.normal(size=(1, 300, 1))).astype(np.complex64)
        weights = np.ones((1, 300, 1), np.float32)
        mueller = np.eye(1, dtype=np.complex64)
        ch5 = preprocess.VisibilityCollectorSpill(
            str(tmp_path / "vis"), [ip], [gp])
        ch5.add(uvw, weights, vis, mueller_stokes=mueller)
        ch5.close()
        r = ch5.reader()
        for s in range(gp.w_slices):
            whole = r.slice_arrays(0, s)
            # yielded chunks are views into a recycled buffer: copy
            blocks = [
                preprocess.VisChunk(*(c[f].copy() for f in (
                    "uv", "sub_uv", "w_plane", "weights", "vis")))
                for c in r.iter_slice(0, s, 37)]
            assert sum(len(b) for b in blocks) == len(whole)
            if not blocks:
                continue
            for field in ("uv", "sub_uv", "w_plane", "weights", "vis"):
                np.testing.assert_array_equal(
                    np.concatenate([b[field] for b in blocks]),
                    whole[field])
            cu, cs, cw = r.slice_coords(0, s)
            np.testing.assert_array_equal(cu, whole.uv)
            np.testing.assert_array_equal(cs, whole.sub_uv)
            np.testing.assert_array_equal(cw, whole.w_plane)
        r.close()
