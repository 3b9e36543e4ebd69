"""Dense-matmul gridder vs the scatter oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from katsdpimager_tpu.ops import gridder, mxu_gridder


def random_case(rng, pixels=256, K=12, oversample=4, w_planes=3, pols=2,
                n=400, clustered=True):
    kernel = (rng.normal(size=(w_planes, oversample, K))
              + 1j * rng.normal(size=(w_planes, oversample, K))).astype(np.complex64)
    half = pixels // 2
    lim = half - K
    if clustered:
        # Gaussian-clustered UV (realistic: dense centre)
        uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                     ).astype(np.int16)
    else:
        uv = rng.integers(-lim, lim, size=(n, 2)).astype(np.int16)
    sub_uv = rng.integers(0, oversample, size=(n, 2)).astype(np.int16)
    w_plane = rng.integers(0, w_planes, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, pols)) + 1j * rng.normal(size=(n, pols))
           ).astype(np.complex64)
    weights = rng.uniform(0.3, 2.0, size=(n, pols)).astype(np.float32)
    weights_grid = rng.uniform(0.5, 2.0, size=(pols, pixels, pixels)
                               ).astype(np.float32)
    return kernel, uv, sub_uv, w_plane, vis, weights, weights_grid


@pytest.mark.parametrize("clustered", [True, False])
def test_grid_matches_oracle(clustered):
    rng = np.random.default_rng(17)
    kernel, uv, sub_uv, w_plane, vis, _wt, wg = random_case(
        rng, clustered=clustered)
    pixels = wg.shape[-1]
    pols = vis.shape[1]

    expected = gridder.grid_vis_reference(
        np.zeros((pols, pixels, pixels), np.complex64),
        kernel, wg, uv, sub_uv, w_plane, vis)

    g = mxu_gridder.MxuGridder(pixels=pixels, kernel_width=kernel.shape[-1],
                               num_pols=pols, rv=32, ru=32, mc=64)
    plan = g.plan(uv, sub_uv, w_plane, vis, np.ones_like(_wt))
    out = g.grid(jnp.zeros((pols, pixels, pixels), jnp.complex64),
                 jnp.asarray(kernel), jnp.asarray(wg), plan)
    np.testing.assert_allclose(np.asarray(out), expected, rtol=2e-4, atol=2e-4)


def test_degrid_matches_oracle():
    rng = np.random.default_rng(23)
    kernel, uv, sub_uv, w_plane, vis, weights, wg = random_case(rng)
    pixels = wg.shape[-1]
    pols = vis.shape[1]
    grid = (rng.normal(size=(pols, pixels, pixels))
            + 1j * rng.normal(size=(pols, pixels, pixels))).astype(np.complex64)

    expected = gridder.degrid_vis_reference(
        grid, kernel, uv, sub_uv, w_plane, weights, vis)

    g = mxu_gridder.MxuGridder(pixels=pixels, kernel_width=kernel.shape[-1],
                               num_pols=pols, rv=32, ru=32, mc=64)
    plan = g.plan(uv, sub_uv, w_plane, vis, weights)
    vis_chunked = g.chunk_vis(plan, vis)
    out_chunked = g.degrid(jnp.asarray(grid), jnp.asarray(kernel), plan,
                           jnp.asarray(vis_chunked))
    out = g.unchunk_vis(plan, np.asarray(out_chunked), len(vis))
    np.testing.assert_allclose(out, expected, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("clustered", [True, False])
def test_device_plan_matches_host(clustered):
    """plan_chunks_tiled_device reproduces the host plan bit-for-bit."""
    rng = np.random.default_rng(31)
    kernel, uv, sub_uv, w_plane, vis, weights, wg = random_case(
        rng, clustered=clustered, K=12, n=777)
    pixels = wg.shape[-1]
    ts, mc = 32, 64
    host = mxu_gridder.plan_chunks_tiled(
        uv, sub_uv, w_plane, vis, weights, pixels=pixels,
        kernel_width=kernel.shape[-1], ts=ts, mc=mc)
    nc = host.uv.shape[0]
    dev = mxu_gridder.plan_chunks_tiled_device(
        jnp.asarray(uv.astype(np.int32)), jnp.asarray(sub_uv.astype(np.int32)),
        jnp.asarray(w_plane.astype(np.int32)), jnp.asarray(vis),
        jnp.asarray(weights), pixels=pixels,
        kernel_width=kernel.shape[-1], ts=ts, mc=mc, nc=nc)
    assert int(dev["n_chunks"]) == int(host.valid.any(axis=1).sum())
    np.testing.assert_array_equal(np.asarray(dev["uv"]), host.uv)
    np.testing.assert_array_equal(np.asarray(dev["sub_uv"]), host.sub_uv)
    np.testing.assert_array_equal(np.asarray(dev["w_plane"]), host.w_plane)
    np.testing.assert_array_equal(np.asarray(dev["valid"]), host.valid)
    np.testing.assert_array_equal(np.asarray(dev["vis"]), host.vis)
    np.testing.assert_array_equal(np.asarray(dev["weights"]), host.weights)
    # anchors agree on populated chunks (host leaves empty ones zero too)
    np.testing.assert_array_equal(np.asarray(dev["anchor"]), host.anchor)
    np.testing.assert_array_equal(np.asarray(dev["row_chunk"]),
                                  host.row_chunk)
    np.testing.assert_array_equal(np.asarray(dev["row_slot"]),
                                  host.row_slot)


ASSEMBLIES = ["fft", "matmul", "tapsmm", "onehot", "joint", "tapdict"]


@pytest.mark.parametrize("assembly", ASSEMBLIES)
def test_degrid_assembly_matches_oracle(assembly):
    rng = np.random.default_rng(29)
    kernel, uv, sub_uv, w_plane, vis, weights, wg = random_case(rng)
    pixels = wg.shape[-1]
    pols = vis.shape[1]
    grid = (rng.normal(size=(pols, pixels, pixels))
            + 1j * rng.normal(size=(pols, pixels, pixels))).astype(np.complex64)

    expected = gridder.degrid_vis_reference(
        grid, kernel, uv, sub_uv, w_plane, weights, vis)

    rv = ru = 32
    g = mxu_gridder.MxuGridder(pixels=pixels, kernel_width=kernel.shape[-1],
                               num_pols=pols, rv=rv, ru=ru, mc=64)
    plan = g.plan(uv, sub_uv, w_plane, vis, weights)
    gpad = jnp.pad(jnp.asarray(grid), ((0, 0), (0, rv), (0, ru)))
    out_chunked = mxu_gridder.degrid_chunks_impl(
        gpad, jnp.asarray(kernel), jnp.asarray(plan.uv),
        jnp.asarray(plan.sub_uv), jnp.asarray(plan.w_plane),
        jnp.asarray(plan.weights), jnp.asarray(plan.vis),
        jnp.asarray(plan.anchor), jnp.asarray(plan.valid),
        pixels=pixels, rv=rv, ru=ru, assembly=assembly)
    out = g.unchunk_vis(plan, np.asarray(out_chunked), len(vis))
    np.testing.assert_allclose(out, expected, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("assembly", ASSEMBLIES)
def test_degrid_tile_aligned_matches_oracle(assembly):
    """Each assembly's degrid on a TILE-ALIGNED plan (the dense mode and
    cube layout: anchors are multiples of ``ts``, windows ``(ts+K)^2``
    inside the dense pad) matches the scatter oracle."""
    rng = np.random.default_rng(31)
    kernel, uv, sub_uv, w_plane, vis, weights, wg = random_case(rng)
    pixels = wg.shape[-1]
    pols = vis.shape[1]
    grid = (rng.normal(size=(pols, pixels, pixels))
            + 1j * rng.normal(size=(pols, pixels, pixels))
            ).astype(np.complex64)

    ts = 32
    plan = mxu_gridder.plan_chunks_tiled(
        uv, sub_uv, w_plane, vis, weights,
        pixels=pixels, kernel_width=kernel.shape[-1], ts=ts, mc=64)
    assert np.all(plan.anchor % ts == 0)
    ext = mxu_gridder.dense_pad_size(pixels, ts)
    gpad = jnp.pad(jnp.asarray(grid),
                   ((0, 0), (0, ext - pixels), (0, ext - pixels)))
    out_chunked = mxu_gridder.degrid_chunks_impl(
        gpad, jnp.asarray(kernel), jnp.asarray(plan.uv),
        jnp.asarray(plan.sub_uv), jnp.asarray(plan.w_plane),
        jnp.asarray(plan.weights), jnp.asarray(plan.vis),
        jnp.asarray(plan.anchor), jnp.asarray(plan.valid),
        pixels=pixels, rv=ts, ru=ts, assembly=assembly)

    expected = gridder.degrid_vis_reference(
        grid, kernel, uv, sub_uv, w_plane, weights, vis)
    got = np.zeros_like(expected)
    got[...] = np.nan
    oc = np.asarray(out_chunked)
    for r, (c, s) in enumerate(zip(plan.row_chunk, plan.row_slot)):
        got[r] = oc[c, s]
    np.testing.assert_allclose(got, expected, rtol=2e-3, atol=2e-3)


def test_autotune_measures_and_caches(tmp_path, monkeypatch):
    from katsdpimager_tpu.ops import autotune

    monkeypatch.setenv("KTPU_AUTOTUNE", "1")
    monkeypatch.setenv("KTPU_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    geo = dict(pixels=128, kernel_width=8, num_pols=1, ts=16, mc=32)
    best = autotune.lookup(**geo, n_vis=2048)
    assert best["assembly"] in ("fft", "matmul", "tapsmm", "onehot",
                                "joint", "tapdict")
    assert best["group"] in (64, 128, 256, 512, 1024, 2048)
    # second call is a pure cache hit (no KTPU_AUTOTUNE needed)
    monkeypatch.delenv("KTPU_AUTOTUNE")
    again = autotune.lookup(**geo)
    assert again == best
    # without env and without cache: no tuning
    monkeypatch.setenv("KTPU_AUTOTUNE_CACHE", str(tmp_path / "empty.json"))
    assert autotune.lookup(**geo) is None


def test_empty():
    g = mxu_gridder.MxuGridder(pixels=64, kernel_width=8, num_pols=1)
    plan = g.plan(np.zeros((0, 2), np.int16), np.zeros((0, 2), np.int16),
                  np.zeros((0,), np.int16), np.zeros((0, 1), np.complex64),
                  np.zeros((0, 1), np.float32))
    out = g.grid(jnp.zeros((1, 64, 64), jnp.complex64),
                 jnp.zeros((1, 4, 8), jnp.complex64),
                 jnp.ones((1, 64, 64), jnp.float32), plan)
    np.testing.assert_array_equal(np.asarray(out), 0)


def test_chunk_plan_invariants():
    rng = np.random.default_rng(5)
    kernel, uv, sub_uv, w_plane, vis, weights, wg = random_case(rng, n=1000)
    pixels = wg.shape[-1]
    K = kernel.shape[-1]
    g = mxu_gridder.MxuGridder(pixels=pixels, kernel_width=K, num_pols=2,
                               rv=32, ru=32, mc=64)
    plan = g.plan(uv, sub_uv, w_plane, vis, weights)
    uv_bias = (K - 1) // 2 - pixels // 2
    # every valid vis footprint fits its chunk window
    for c in range(plan.uv.shape[0]):
        m = plan.valid[c]
        if not m.any():
            continue
        v0 = plan.uv[c, m, 1] - uv_bias
        u0 = plan.uv[c, m, 0] - uv_bias
        assert (v0 >= plan.anchor[c, 0]).all()
        assert (v0 + K <= plan.anchor[c, 0] + 32 + K).all()
        assert (u0 >= plan.anchor[c, 1]).all()
        assert (u0 + K <= plan.anchor[c, 1] + 32 + K).all()
    # round trip of vis through chunk layout
    back = g.unchunk_vis(plan, plan.vis, len(vis))
    np.testing.assert_array_equal(back, vis)


@pytest.mark.parametrize("clustered", [True, False])
@pytest.mark.parametrize("assembly", ["fft", "matmul", "tapsmm", "onehot", "joint", "tapdict"])
def test_dense_grid_matches_oracle(clustered, assembly):
    rng = np.random.default_rng(19)
    kernel, uv, sub_uv, w_plane, vis, _wt, wg = random_case(
        rng, clustered=clustered, K=12, n=600)
    pixels = wg.shape[-1]
    pols = vis.shape[1]
    ts = 32

    expected = gridder.grid_vis_reference(
        np.zeros((pols, pixels, pixels), np.complex64),
        kernel, wg, uv, sub_uv, w_plane, vis)

    plan = mxu_gridder.plan_chunks_tiled(
        uv, sub_uv, w_plane, vis, np.ones_like(_wt),
        pixels=pixels, kernel_width=kernel.shape[-1], ts=ts, mc=64)
    # anchors tile-aligned
    assert np.all(plan.anchor % ts == 0)
    ext = mxu_gridder.dense_pad_size(pixels, ts)
    gpad = jnp.zeros((pols, ext, ext), jnp.complex64)
    out = mxu_gridder.grid_chunks_dense(
        gpad, jnp.asarray(kernel), jnp.asarray(wg),
        jnp.asarray(plan.uv), jnp.asarray(plan.sub_uv),
        jnp.asarray(plan.w_plane), jnp.asarray(plan.vis),
        jnp.asarray(plan.anchor), jnp.asarray(plan.valid),
        pixels=pixels, ts=ts, group=64, assembly=assembly)
    out = np.asarray(out)[:, :pixels, :pixels]
    np.testing.assert_allclose(out, expected, rtol=2e-4, atol=2e-4)
    # nothing may leak outside the nominal grid... (it can live in the pad,
    # which the caller crops; just check the crop equals the oracle, done)


@pytest.mark.parametrize("assembly", ["fft", "tapsmm"])
def test_dense_grid_dynamic_chunk_bound(assembly):
    """n_chunks bounds the group loop without changing the result, and a
    too-small bound drops exactly the trailing chunks (occupied-first)."""
    rng = np.random.default_rng(41)
    kernel, uv, sub_uv, w_plane, vis, _wt, wg = random_case(
        rng, clustered=True, K=12, n=600)
    pixels = wg.shape[-1]
    pols = vis.shape[1]
    ts = 32
    plan = mxu_gridder.plan_chunks_tiled(
        uv, sub_uv, w_plane, vis, np.ones_like(_wt),
        pixels=pixels, kernel_width=kernel.shape[-1], ts=ts, mc=64)
    n_occ = int(plan.valid.any(axis=1).sum())
    assert 0 < n_occ <= plan.uv.shape[0]
    ext = mxu_gridder.dense_pad_size(pixels, ts)

    def run(n_chunks):
        gpad = jnp.zeros((pols, ext, ext), jnp.complex64)
        out = mxu_gridder.grid_chunks_dense(
            gpad, jnp.asarray(kernel), jnp.asarray(wg),
            jnp.asarray(plan.uv), jnp.asarray(plan.sub_uv),
            jnp.asarray(plan.w_plane), jnp.asarray(plan.vis),
            jnp.asarray(plan.anchor), jnp.asarray(plan.valid),
            None, n_chunks,
            pixels=pixels, ts=ts, group=32, assembly=assembly)
        return np.asarray(out)[:, :pixels, :pixels]

    full = run(None)
    np.testing.assert_allclose(run(jnp.int32(n_occ)), full, rtol=1e-6)
    # a bound covering only the first group grids a strict subset
    partial_out = run(jnp.int32(1))
    assert np.abs(partial_out).sum() < np.abs(full).sum()

    # degrid: bounded loop matches, unprocessed padding passes through
    grid = (rng.normal(size=(pols, pixels, pixels))
            + 1j * rng.normal(size=(pols, pixels, pixels))
            ).astype(np.complex64)
    gpad = jnp.pad(jnp.asarray(grid), ((0, 0), (0, ts), (0, ts)))

    def run_degrid(n_chunks):
        return np.asarray(mxu_gridder.degrid_chunks_impl(
            gpad, jnp.asarray(kernel), jnp.asarray(plan.uv),
            jnp.asarray(plan.sub_uv), jnp.asarray(plan.w_plane),
            jnp.asarray(plan.weights), jnp.asarray(plan.vis),
            jnp.asarray(plan.anchor), jnp.asarray(plan.valid),
            n_chunks, pixels=pixels, rv=ts, ru=ts, group=32,
            assembly=assembly))

    np.testing.assert_allclose(run_degrid(jnp.int32(n_occ)),
                               run_degrid(None), rtol=1e-6, atol=1e-6)


def test_plan_coords_matches_full_plan():
    """plan_chunks_tiled_coords produces exactly the assignment the full
    planner uses, and the row mapping round-trips payload placement."""
    rng = np.random.default_rng(9)
    n, pixels, K, ts, mc = 5000, 512, 16, 64, 64
    lim = pixels // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, 8, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, 4, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, 1))
           + 1j * rng.normal(size=(n, 1))).astype(np.complex64)
    wts = rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32)

    plan = mxu_gridder.plan_chunks_tiled(
        uv, sub, wp, vis, wts, pixels=pixels, kernel_width=K, ts=ts, mc=mc)
    asg = mxu_gridder.plan_chunks_tiled_coords(
        uv, pixels=pixels, kernel_width=K, ts=ts, mc=mc)

    np.testing.assert_array_equal(asg["row_chunk"], plan.row_chunk)
    np.testing.assert_array_equal(asg["row_slot"], plan.row_slot)
    np.testing.assert_array_equal(asg["anchor"], plan.anchor)
    np.testing.assert_array_equal(asg["valid"], plan.valid)

    # streamed placement via the per-ROW mapping reproduces the payload
    out = np.zeros_like(plan.vis)
    for start in range(0, n, 777):   # arbitrary block size
        rr = slice(start, min(n, start + 777))
        out[asg["row_chunk"][rr], asg["row_slot"][rr]] = vis[rr]
    np.testing.assert_array_equal(out, plan.vis)


def test_plan_count_matches_full_plan():
    """plan_chunks_tiled_count (bincount layout sizing, no argsort) must
    equal the full planner's n_chunks, including at geometries whose tile
    keys exceed the narrowed int16 sort-key range."""
    rng = np.random.default_rng(11)
    for pixels, ts in [(512, 64), (16384, 64)]:   # int16 and int32 keys
        K, mc = 16, 64
        lim = pixels // 2 - K - 1
        uv = np.clip(rng.normal(scale=lim / 3, size=(3000, 2)),
                     -lim, lim).astype(np.int32)
        asg = mxu_gridder.plan_chunks_tiled_coords(
            uv, pixels=pixels, kernel_width=K, ts=ts, mc=mc)
        count = mxu_gridder.plan_chunks_tiled_count(
            uv, pixels=pixels, kernel_width=K, ts=ts, mc=mc)
        assert count == asg["n_chunks"] > 0
    assert mxu_gridder.plan_chunks_tiled_count(
        np.zeros((0, 2), np.int16), pixels=512, kernel_width=16) == 0
