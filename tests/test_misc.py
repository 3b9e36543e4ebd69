"""Unit tests for auxiliary subsystems: FITS I/O, arguments round-trip,
profiler semantics, metadata, sky model parsing, primary beam."""

import math

import numpy as np
import pytest

from katsdpimager_tpu import (
    arguments, io, metadata, parameters, polarization, primary_beam,
    profiling, simulate, sky_model,
)


def make_ip(pols=(polarization.STOKES_I,), pixels=64):
    fixed = parameters.FixedImageParameters(tuple(pols))
    return parameters.ImageParameters(fixed, wavelength=0.21,
                                      pixel_size=1e-4, pixels=pixels)


class TestFitsIO:
    def test_round_trip(self, tmp_path):
        ip = make_ip()
        rng = np.random.default_rng(1)
        image = rng.normal(size=(1, 64, 64)).astype(np.float32)
        path = str(tmp_path / "x.fits")
        io.write_fits_image(image, ip, path, (0.9, -0.6))
        header, data = io.read_fits(path)
        assert data.shape == (1, 1, 64, 64)
        np.testing.assert_allclose(np.asarray(data[0, 0, :, ::-1]), image[0],
                                   rtol=1e-6)
        assert header["CRVAL1"] == pytest.approx(math.degrees(0.9))
        assert header["CRVAL2"] == pytest.approx(math.degrees(-0.6))
        assert header["CDELT2"] == pytest.approx(math.degrees(math.asin(1e-4)))
        assert header["CRPIX1"] == 32.0
        assert header["CRPIX2"] == 33.0
        assert header["NAXIS"] == 4

    def test_stokes_axis_permutation(self, tmp_path):
        ip = make_ip(pols=polarization.STOKES_IQUV)
        image = np.zeros((4, 64, 64), np.float32)
        for i in range(4):
            image[i] += i
        path = str(tmp_path / "x.fits")
        io.write_fits_image(image, ip, path)
        header, data = io.read_fits(path)
        assert header["CRVAL3"] == 1.0
        assert header["CDELT3"] == 1.0
        np.testing.assert_array_equal(data[0, :, 0, 0], [0, 1, 2, 3])

    def test_nan_handling(self, tmp_path):
        ip = make_ip()
        image = np.full((1, 64, 64), np.nan, np.float32)
        image[0, 0, 0] = 1.0
        path = str(tmp_path / "x.fits")
        io.write_fits_image(image, ip, path)
        header, data = io.read_fits(path)
        assert header["DATAMIN"] == 1.0


class TestArguments:
    def test_changed_tracking(self):
        import argparse

        parser = argparse.ArgumentParser()
        parser.add_argument("--alpha", type=float, default=1.0)
        parser.add_argument("--beta", type=int, default=2)
        parser.add_argument("--flag", action="store_true")
        args = parser.parse_args(["--alpha", "3.5"],
                                 namespace=arguments.SmartNamespace())
        assert args.changed("alpha")
        assert not args.changed("beta")
        out = arguments.unparse_args(args)
        assert out == ["--alpha=3.5"]


class TestProfiler:
    def test_flamegraph_exclusive(self):
        prof = profiling.FlamegraphProfiler()
        old = profiling.Profiler.get_profiler()
        profiling.Profiler.set_profiler(prof)
        try:
            with profiling.profile("outer"):
                with profiling.profile("inner"):
                    pass
        finally:
            profiling.Profiler.set_profiler(old)
        assert ("outer",) in prof.inclusive
        assert ("outer", "inner") in prof.inclusive
        excl = prof.exclusive()
        assert excl[("outer",)] <= prof.inclusive[("outer",)]

    def test_collect(self):
        prof = profiling.CollectProfiler()
        old = profiling.Profiler.get_profiler()
        profiling.Profiler.set_profiler(prof)
        try:
            with profiling.profile("a"):
                pass
        finally:
            profiling.Profiler.set_profiler(old)
        assert [r.stack for r in prof.records] == [("a",)]


class TestSkyModel:
    def test_parse_lsm(self):
        model = sky_model.parse_text_model(
            "# comment\n"
            "3:30:00 -35:00:00 1 0 0 0\n"
            "52.5 -35.5 2.5\n")
        assert len(model) == 2
        assert model.positions[0, 0] == pytest.approx(math.radians(52.5))
        assert model.positions[0, 1] == pytest.approx(math.radians(-35.0))
        np.testing.assert_allclose(model.flux_iquv[1], [2.5, 0, 0, 0])

    def test_lmn_at_centre(self):
        model = sky_model.parse_text_model("45.0 -30.0 1.0\n")
        lmn = model.lmn((math.radians(45.0), math.radians(-30.0)))
        np.testing.assert_allclose(lmn, 0.0, atol=1e-12)


class TestPrimaryBeam:
    def test_airy_peak_and_null(self):
        beam = primary_beam.airy_beam(13.5, freq_range=(1e9, 1.5e9))
        assert beam.sample(0.0, 1.2e9) == pytest.approx(1.0)
        # First null at sin(theta) = 1.22 lambda / D
        wavelength = 299792458.0 / 1.2e9
        null = 1.22 * wavelength / 13.5
        assert beam.sample(null, 1.2e9) < 1e-3
        grid = beam.sample_grid(np.linspace(-0.01, 0.01, 33),
                                np.linspace(-0.01, 0.01, 33), 1.2e9)
        assert grid.shape == (33, 33)
        assert grid[16, 16] == pytest.approx(1.0, abs=1e-6)

    def test_meerkat_measured(self):
        """The bundled measured MeerKAT tables load and return physical
        power values (reference samples katsdpmodels v1 tables,
        primary_beam.py:179-188)."""
        beam = primary_beam.meerkat_v1_beam("L")
        assert beam.band == "L"
        assert beam.frequencies[0] == pytest.approx(856e6)
        assert beam.frequencies[-1] == pytest.approx(1711164062.5)
        # boresight power close to (but not exactly, it is measured) 1
        centre = beam.sample(0.0, 1.2e9)
        assert 0.9 < centre < 1.05
        # power decreases with radius and the beam has a finite extent
        r = beam.radii
        mid = beam.sample(r[len(r) // 3], 1.2e9)
        assert 0.0 < mid < centre
        # UHF band loads too; unknown bands are rejected
        assert primary_beam.meerkat_v1_beam("UHF").band == "UHF"
        with pytest.raises(ValueError):
            primary_beam.meerkat_v1_beam("X")

    def test_meerkat_fallback_airy(self, tmp_path, monkeypatch):
        """Without a bundled table the Airy pattern stands in."""
        import katsdpimager_tpu.primary_beam as pb

        monkeypatch.setattr(
            "os.path.exists", lambda p: False)
        beam = pb.meerkat_v1_beam("L")
        assert beam.sample(0.0, 1.2e9) == pytest.approx(1.0)


class TestMetadata:
    def test_make_metadata(self, tmp_path):
        simulate.make_sim_dataset(str(tmp_path / "s.h5"), num_antennas=8,
                                  num_times=4)
        from katsdpimager_tpu import loader

        ds = loader.load(str(tmp_path / "s.h5"), [])
        md = metadata.make_metadata(ds, None, [0])
        assert md["RightAscension"] == pytest.approx(52.5)
        assert md["Declination"] == pytest.approx(-35.0)
        assert md["Channels"] == [0]
        metadata.write_metadata(str(tmp_path / "m.json"), md)
        import json

        with open(tmp_path / "m.json") as f:
            assert json.load(f)["ImagerVersion"]
        ds.close()


class TestSimulatorPhysics:
    def test_uvw_phase_consistency(self):
        """The simulated visibility of a single off-centre source must equal
        the analytic DFT at the generated UVW."""
        ants = simulate.random_array(6, 300.0)
        src = simulate.Source(simulate.DEFAULT_PHASE_CENTRE[0] + 0.002,
                              simulate.DEFAULT_PHASE_CENTRE[1] + 0.001,
                              (2.0, 0, 0, 0))
        freq = 1e9
        uvw, vis = simulate.simulate_vis(
            ants, math.radians(-30.7), simulate.DEFAULT_PHASE_CENTRE,
            [freq], [src], np.array([0.3]))
        l, m, n = simulate.lmn(np.array([src.ra]), np.array([src.dec]),
                               *simulate.DEFAULT_PHASE_CENTRE)
        wavelength = 299792458.0 / freq
        phase = (uvw @ np.array([l[0], m[0], n[0] - 1])) / wavelength
        expected_xx = 2.0 * np.exp(-2j * np.pi * phase)
        np.testing.assert_allclose(vis[0, :, 0], expected_xx, rtol=1e-4)

    def test_w_sign_convention(self):
        """UVW must satisfy |baseline| invariance (rotation only)."""
        ants = simulate.random_array(4, 300.0)
        xyz = simulate.enu_to_xyz(ants, math.radians(-30.7))
        bl = xyz[1] - xyz[0]
        u, v, w = simulate.xyz_to_uvw(bl, np.array([0.1, 0.7]), -0.6)
        for i in range(2):
            assert np.hypot(np.hypot(u[i], v[i]), w[i]) == pytest.approx(
                np.linalg.norm(bl))


class TestSpectralModel:
    def test_power_law(self):
        model = sky_model.parse_text_model(
            "45.0 -30.0 2.0 0 0 0 -0.7 1400\n")
        f0 = model.flux_density(299792458.0 / 1.4e9)
        np.testing.assert_allclose(f0[0, 0], 2.0)
        f2 = model.flux_density(299792458.0 / 2.8e9)
        np.testing.assert_allclose(f2[0, 0], 2.0 * 2 ** -0.7, rtol=1e-12)


class TestFitsVideo:
    def test_gif_render(self, tmp_path):
        from katsdpimager_tpu import fits_video

        ip = make_ip()
        rng = np.random.default_rng(2)
        for ch in range(2):
            img = rng.normal(size=(1, 64, 64)).astype(np.float32)
            io.write_fits_image(img, ip, str(tmp_path / f"c{ch}.fits"))
        out = str(tmp_path / "v.gif")
        assert fits_video.main([str(tmp_path / "c*.fits"), out]) == 0
        assert (tmp_path / "v.gif").stat().st_size > 0


def test_katpoint_flux_ef_terms():
    """Coefficients e and f multiply the frequency in MHz (katpoint
    FluxDensityModel semantics), not higher log powers."""
    from katsdpimager_tpu import sky_model

    t = sky_model.KatpointTarget(
        "src, radec, 3:30:00, -35:00:00, (500 2000 1.0 -0.7 0 0 0.001 0)")
    s = t.flux_density_stokes(1e9)
    expect = 10.0 ** (1.0 - 0.7 * 3.0 + 0.001 * 1000.0)
    assert s[0] == pytest.approx(expect, rel=1e-9)


class TestFitsDiffWcs:
    def test_self_and_shifted(self, tmp_path):
        """fitsdiffwcs compares at world coordinates: an image matched
        against itself is exact, and against a copy whose reference pixel
        is shifted the WCS-aware lookup still lines the sources up."""
        import importlib.util
        import os

        spec = importlib.util.spec_from_file_location(
            "fitsdiffwcs", os.path.join(os.path.dirname(__file__), "..",
                                        "scripts", "fitsdiffwcs.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)

        ip = make_ip(pixels=64)
        rng = np.random.default_rng(2)
        image = rng.normal(size=(1, 64, 64)).astype(np.float32)
        p1 = str(tmp_path / "a.fits")
        io.write_fits_image(image, ip, p1, (0.9, -0.6))
        assert mod.main([p1, p1, "--tolerance", "1e-6"]) == 0

        a = mod.WcsImage(p1)
        ra, dec = a.world_grid()
        same = a.sample(ra, dec, 0)
        finite = np.isfinite(same)
        assert finite.sum() > 3000
        np.testing.assert_allclose(same[finite],
                                   a.data[0][finite], atol=1e-5)


def test_device_profile_capture(tmp_path):
    """device_trace -> parse_device_profile -> write_device_profile round
    trip (the --write-device-profile path; on the CPU the host executor
    lines stand in for a device plane)."""
    import jax
    import jax.numpy as jnp

    from katsdpimager_tpu import profiling

    d = str(tmp_path / "trace")
    with profiling.device_trace(d):
        x = jnp.ones((256, 256))
        with jax.named_scope("stage_x"):
            (x @ x).block_until_ready()
    totals = profiling.parse_device_profile(d)
    assert totals, "no device events parsed from the trace"
    out = tmp_path / "prof.txt"
    with open(out, "w") as f:
        profiling.write_device_profile(totals, f)
    lines = out.read_text().strip().splitlines()
    assert lines and all(" " in ln for ln in lines)
