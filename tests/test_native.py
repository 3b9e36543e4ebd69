"""Native (C++/OpenMP) preprocessing core vs the JAX path."""

import numpy as np
import pytest

from katsdpimager_tpu import native, polarization, preprocess
from tests.test_preprocess import make_params

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


def random_inputs(rng, n=2000, Q=4):
    uvw = rng.uniform(-4000, 4000, size=(n, 3)).astype(np.float32)
    vis = (rng.normal(size=(1, n, Q)) + 1j * rng.normal(size=(1, n, Q))
           ).astype(np.complex64)
    weights = rng.uniform(0.5, 2.0, size=(1, n, Q)).astype(np.float32)
    # flag ~5%
    flags = rng.uniform(size=(1, n, Q)) < 0.05
    weights[flags] = 0.0
    return uvw, weights, vis


def compare_collectors(ip, gp, uvw, weights, vis, mueller, **kwargs):
    cj = preprocess.VisibilityCollectorMem([ip], [gp])
    cj.add(uvw, weights, vis, mueller_stokes=mueller, **kwargs)
    cn = preprocess.VisibilityCollectorNative([ip], [gp])
    cn.add(uvw, weights, vis, mueller_stokes=mueller, **kwargs)
    assert cn.num_output == cj.num_output
    for s in range(gp.w_slices):
        a = cj.reader().slice_arrays(0, s)
        b = cn.reader().slice_arrays(0, s)
        assert len(a) == len(b)
        if len(a) == 0:
            continue
        # Both sorted by the same key order
        np.testing.assert_array_equal(a.uv, b.uv)
        np.testing.assert_array_equal(a.sub_uv, b.sub_uv)
        np.testing.assert_array_equal(a.w_plane, b.w_plane)
        np.testing.assert_allclose(a.weights, b.weights, rtol=1e-5)
        np.testing.assert_allclose(a.vis, b.vis, rtol=1e-4, atol=1e-5)


def test_native_matches_jax_stokes_i():
    ip, gp = make_params(pixels=2048, cell_size=10.0)
    rng = np.random.default_rng(31)
    uvw, weights, vis = random_inputs(rng)
    mueller = polarization.polarization_matrix(
        [polarization.STOKES_I],
        [polarization.STOKES_XX, polarization.STOKES_XY,
         polarization.STOKES_YX, polarization.STOKES_YY])
    compare_collectors(ip, gp, uvw, weights, vis, mueller)


def test_native_matches_jax_iquv():
    ip, gp = make_params(pixels=2048, cell_size=10.0,
                         pols=tuple(polarization.STOKES_IQUV))
    rng = np.random.default_rng(37)
    uvw, weights, vis = random_inputs(rng)
    mueller = polarization.polarization_matrix(
        polarization.STOKES_IQUV,
        [polarization.STOKES_XX, polarization.STOKES_XY,
         polarization.STOKES_YX, polarization.STOKES_YY])
    compare_collectors(ip, gp, uvw, weights, vis, mueller)


def test_native_parallactic():
    ip, gp = make_params(pixels=2048, cell_size=10.0)
    rng = np.random.default_rng(41)
    uvw, weights, vis = random_inputs(rng, n=500)
    from_c, to_c = polarization.polarization_matrices(
        [polarization.STOKES_I],
        [polarization.STOKES_XX, polarization.STOKES_XY,
         polarization.STOKES_YX, polarization.STOKES_YY])
    fa1 = rng.uniform(-1, 1, 500).astype(np.float32)
    fa2 = rng.uniform(-1, 1, 500).astype(np.float32)
    compare_collectors(ip, gp, uvw, weights, vis, from_c,
                       feed_angle1=fa1, feed_angle2=fa2,
                       mueller_circular=to_c)


def test_native_merging():
    ip, gp = make_params()
    uvw = np.array([[343.0, 100.0, 10.0],
                    [50.0, 50.0, 10.0],
                    [343.02, 100.01, 10.0]], np.float32)
    vis = np.array([[[1 + 1j], [5 + 0j], [2 - 1j]]], np.complex64)
    weights = np.array([[[1.0], [1.0], [3.0]]], np.float32)
    mueller = np.eye(1, dtype=np.complex64)
    c = preprocess.VisibilityCollectorNative([ip], [gp])
    c.add(uvw, weights, vis, mueller_stokes=mueller)
    assert c.num_output == 2


def test_engine_param_hdf5_spill(tmp_path):
    """engine="native" composes with disk-spill storage (the cube
    pipeline's auto configuration on an accelerator backend)."""
    ip, gp = make_params()
    rng = np.random.default_rng(11)
    uvw, weights, vis = random_inputs(rng, n=800, Q=1)
    mueller = polarization.polarization_matrix(
        [polarization.STOKES_I], [polarization.STOKES_I])
    cj = preprocess.VisibilityCollectorMem([ip], [gp], engine="jax")
    cj.add(uvw, weights, vis, mueller_stokes=mueller)
    cj.close()
    cn = preprocess.VisibilityCollectorSpill(
        str(tmp_path / "spill"), [ip], [gp], engine="native")
    cn.add(uvw, weights, vis, mueller_stokes=mueller)
    cn.close()
    assert cn.num_output == cj.num_output
    for s in range(gp.w_slices):
        a = cj.reader().slice_arrays(0, s)
        b = cn.reader().slice_arrays(0, s)
        assert len(a) == len(b)
        if len(a):
            np.testing.assert_array_equal(a.uv, b.uv)
            np.testing.assert_allclose(a.vis, b.vis, rtol=1e-4, atol=1e-5)


def test_native_heavy_merge_and_radix_stress():
    """Many duplicated quantized coordinates: stresses the radix sort's
    digit-skip on a coarse grid (few occupied key bits) and the parallel
    run-merge with long runs spanning thread-partition boundaries."""
    ip, gp = make_params(pixels=256, cell_size=50.0)
    rng = np.random.default_rng(43)
    n = 50_000
    # Draw UVW from a tiny set of distinct points so runs are thousands long.
    pool = rng.uniform(-1500, 1500, size=(37, 3)).astype(np.float32)
    uvw = pool[rng.integers(0, len(pool), n)]
    vis = (rng.normal(size=(1, n, 4)) + 1j * rng.normal(size=(1, n, 4))
           ).astype(np.complex64)
    weights = rng.uniform(0.5, 2.0, size=(1, n, 4)).astype(np.float32)
    mueller = polarization.polarization_matrix(
        [polarization.STOKES_I],
        [polarization.STOKES_XX, polarization.STOKES_XY,
         polarization.STOKES_YX, polarization.STOKES_YY])
    compare_collectors(ip, gp, uvw, weights, vis, mueller)


def test_native_all_flagged_is_empty():
    ip, gp = make_params()
    uvw = np.zeros((10, 3), np.float32)
    vis = np.ones((1, 10, 1), np.complex64)
    weights = np.zeros((1, 10, 1), np.float32)   # all flagged
    c = preprocess.VisibilityCollectorNative([ip], [gp])
    c.add(uvw, weights, vis, mueller_stokes=np.eye(1, dtype=np.complex64))
    assert c.num_output == 0


def test_native_pack_slice_matches_numpy():
    """ktpu_pack_slice_coords must reproduce the numpy tile planner's
    chunk assignment, scatter and row mapping bitwise (the cube packer
    switches between them on native availability)."""
    from katsdpimager_tpu.ops import mxu_gridder

    rng = np.random.default_rng(53)
    n, pixels, K, ts, mc = 20000, 1024, 16, 64, 64
    lim = pixels // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, 8, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, 32, size=n).astype(np.int16)

    asg = mxu_gridder.plan_chunks_tiled_coords(
        uv, pixels=pixels, kernel_width=K, ts=ts, mc=mc)
    NC = asg["n_chunks"] + 7    # arbitrary capacity > needed
    ref_uv = np.zeros((NC, mc, 2), np.int32)
    ref_sub = np.zeros((NC, mc, 2), np.int32)
    ref_wp = np.zeros((NC, mc), np.int32)
    ref_anc = np.zeros((NC, 2), np.int32)
    ref_val = np.zeros((NC, mc), bool)
    order = asg["order"]
    dst = (asg["chunk_of"], asg["slot_of"])
    ref_uv[dst] = uv[order]
    ref_sub[dst] = sub[order]
    ref_wp[dst] = wp[order]
    bound = min(NC, len(asg["anchor"]))
    ref_anc[:bound] = asg["anchor"][:bound]
    ref_val[:bound] = asg["valid"][:bound]

    out_uv = np.zeros((NC, mc, 2), np.int32)
    out_sub = np.zeros((NC, mc, 2), np.int32)
    out_wp = np.zeros((NC, mc), np.int32)
    out_anc = np.zeros((NC, 2), np.int32)
    out_val = np.zeros((NC, mc), bool)
    n_chunks, rc, rs = native.pack_slice_coords(
        uv, sub, wp, pixels=pixels, kernel_width=K, ts=ts, mc=mc,
        out_uv=out_uv, out_sub=out_sub, out_wp=out_wp,
        out_anchor=out_anc, out_valid=out_val)
    assert n_chunks == asg["n_chunks"]
    np.testing.assert_array_equal(out_uv, ref_uv)
    np.testing.assert_array_equal(out_sub, ref_sub)
    np.testing.assert_array_equal(out_wp, ref_wp)
    np.testing.assert_array_equal(out_anc, ref_anc)
    np.testing.assert_array_equal(out_val, ref_val)
    np.testing.assert_array_equal(rc, asg["row_chunk"])
    np.testing.assert_array_equal(rs, asg["row_slot"])

    # Overflow: returns the needed count and writes nothing.
    probe = np.zeros((2, mc), np.int32)
    n_over, _, _ = native.pack_slice_coords(
        uv, sub, wp, pixels=pixels, kernel_width=K, ts=ts, mc=mc,
        out_uv=np.zeros((2, mc, 2), np.int32),
        out_sub=np.zeros((2, mc, 2), np.int32), out_wp=probe,
        out_anchor=np.zeros((2, 2), np.int32),
        out_valid=np.zeros((2, mc), bool))
    assert n_over == asg["n_chunks"]
    assert not probe.any()


def test_native_place_payload_matches_numpy():
    from katsdpimager_tpu.ops import mxu_gridder

    rng = np.random.default_rng(59)
    n, pixels, K, ts, mc, P = 10000, 512, 16, 64, 32, 2
    lim = pixels // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, 8, size=(n, 2)).astype(np.int16)
    wpl = rng.integers(0, 32, size=n).astype(np.int16)
    NC = mxu_gridder.plan_chunks_tiled_count(
        uv, pixels=pixels, kernel_width=K, ts=ts, mc=mc) + 1
    outs = dict(out_uv=np.zeros((NC, mc, 2), np.int32),
                out_sub=np.zeros((NC, mc, 2), np.int32),
                out_wp=np.zeros((NC, mc), np.int32),
                out_anchor=np.zeros((NC, 2), np.int32),
                out_valid=np.zeros((NC, mc), bool))
    _, rc, rs = native.pack_slice_coords(
        uv, sub, wpl, pixels=pixels, kernel_width=K, ts=ts, mc=mc, **outs)

    wt = rng.uniform(0.5, 2.0, size=(n, P)).astype(np.float32)
    vis = (rng.normal(size=(n, P))
           + 1j * rng.normal(size=(n, P))).astype(np.complex64)
    ref_w = np.zeros((NC, mc, P), np.float32)
    ref_v = np.zeros((NC, mc, P), np.complex64)
    ref_w[rc, rs] = wt
    ref_v[rc, rs] = vis

    out_w = np.zeros((NC, mc, P), np.float32)
    out_v = np.zeros((NC, mc, P), np.complex64)
    # two blocks, like the streaming reader
    half = n // 2
    native.place_payload(rc[:half], rs[:half], wt[:half], vis[:half],
                         out_w, out_v)
    native.place_payload(rc[half:], rs[half:], wt[half:], vis[half:],
                         out_w, out_v)
    np.testing.assert_array_equal(out_w, ref_w)
    np.testing.assert_array_equal(out_v, ref_v)
