"""Mathematical invariants: gridder/degridder adjointness, loader limits."""

import numpy as np
import jax.numpy as jnp
import pytest

from katsdpimager_tpu.ops import gridder, mxu_gridder


def test_grid_degrid_adjoint():
    """<grid(vis), G> = <vis, predict(G)> where predict is the degrid
    gather: the gridder (with conj kernel) and degridder (plain kernel) are
    adjoint linear maps.  This pins both index conventions and conjugation
    against each other independently of the oracles."""
    rng = np.random.default_rng(123)
    pixels, K, oversample, w_planes, pols, n = 64, 8, 4, 2, 1, 40
    kernel = (rng.normal(size=(w_planes, oversample, K))
              + 1j * rng.normal(size=(w_planes, oversample, K))
              ).astype(np.complex64)
    lim = pixels // 2 - K - 1
    uv = rng.integers(-lim, lim, size=(n, 2)).astype(np.int16)
    sub = rng.integers(0, oversample, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, w_planes, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, pols)) + 1j * rng.normal(size=(n, pols))
           ).astype(np.complex64)
    G = (rng.normal(size=(pols, pixels, pixels))
         + 1j * rng.normal(size=(pols, pixels, pixels))).astype(np.complex64)
    ones_grid = np.ones((pols, pixels, pixels), np.float32)

    gridded = np.asarray(gridder.grid_vis(
        jnp.zeros((pols, pixels, pixels), jnp.complex64), jnp.asarray(kernel),
        jnp.asarray(ones_grid), jnp.asarray(uv), jnp.asarray(sub),
        jnp.asarray(wp), jnp.asarray(vis), pixels=pixels))
    lhs = np.vdot(G, gridded)  # sum conj(G) * grid(vis)

    # predict(G)[i] = sum_taps kernel * G  (degrid with weights=1, vis=0
    # gives -predict)
    predicted = -np.asarray(gridder.degrid_vis(
        jnp.asarray(G), jnp.asarray(kernel), jnp.asarray(uv),
        jnp.asarray(sub), jnp.asarray(wp),
        jnp.ones((n, pols), jnp.float32),
        jnp.zeros((n, pols), jnp.complex64), pixels=pixels))
    # Adjoint with our conventions: grid applies conj(kernel), degrid
    # applies kernel, so <G, grid(vis)> = conj(<predict(conj-free G), vis>)
    rhs = np.vdot(predicted, vis)
    assert lhs == pytest.approx(rhs, rel=1e-4)


def test_mxu_adjoint():
    """Same adjointness through the matmul chunked paths."""
    rng = np.random.default_rng(321)
    pixels, K, oversample, w_planes, pols, n = 64, 8, 4, 2, 1, 60
    kernel = (rng.normal(size=(w_planes, oversample, K))
              + 1j * rng.normal(size=(w_planes, oversample, K))
              ).astype(np.complex64)
    lim = pixels // 2 - K - 1
    uv = rng.integers(-lim, lim, size=(n, 2)).astype(np.int16)
    sub = rng.integers(0, oversample, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, w_planes, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, pols)) + 1j * rng.normal(size=(n, pols))
           ).astype(np.complex64)
    weights = np.ones((n, pols), np.float32)
    G = (rng.normal(size=(pols, pixels, pixels))
         + 1j * rng.normal(size=(pols, pixels, pixels))).astype(np.complex64)

    g = mxu_gridder.MxuGridder(pixels=pixels, kernel_width=K, num_pols=pols,
                               rv=16, ru=16, mc=32)
    plan = g.plan(uv, sub, wp, vis, weights)
    gridded = np.asarray(g.grid(
        jnp.zeros((pols, pixels, pixels), jnp.complex64),
        jnp.asarray(kernel), jnp.ones((pols, pixels, pixels), jnp.float32),
        plan))
    lhs = np.vdot(G, gridded)

    zero_chunked = jnp.zeros(plan.vis.shape, jnp.complex64)
    pred_chunked = -np.asarray(g.degrid(jnp.asarray(G), jnp.asarray(kernel),
                                        plan, zero_chunked))
    predicted = g.unchunk_vis(plan, pred_chunked, n)
    rhs = np.vdot(predicted, vis)
    assert lhs == pytest.approx(rhs, rel=1e-4)


def test_vis_limit():
    from katsdpimager_tpu import loader

    class FakeDS:
        def data_iter(self, start, stop, max_chunk_vis=None):
            for i in range(4):
                yield {
                    "uvw": np.zeros((10, 3), np.float32),
                    "vis": np.zeros((1, 10, 2), np.complex64),
                    "weights": np.ones((1, 10, 2), np.float32),
                    "progress": (i + 1) * 10, "total": 40,
                }

    chunks = list(loader.data_iter(FakeDS(), 25, None, 0, 1))
    total = sum(len(c["uvw"]) for c in chunks)
    assert total == 25
    assert chunks[-1]["vis"].shape[1] == 5


def test_channel_mask(tmp_path):
    import h5py

    from katsdpimager_tpu import loader, simulate

    path = str(tmp_path / "m.h5")
    simulate.make_sim_dataset(path, num_antennas=8, num_times=4,
                              num_channels=3)
    with h5py.File(path, "r+") as f:
        f.attrs["channel_mask"] = np.array([True, False, True])
    ds = loader.load(path, [])
    assert ds.channel_enabled(0)
    assert not ds.channel_enabled(1)
    assert ds.channel_enabled(2)
    ds.close()
