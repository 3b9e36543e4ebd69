"""End-to-end pipeline test: simulate a tiny MeerKAT-like observation,
image it through the full CLI path, and assert flux recovery against ground
truth — closing the gap the reference leaves open (SURVEY.md §4.8: no
numeric E2E assertions in its CI).

The flux assertion compares the restored image against the *truth* image
(true components convolved with the fitted restoring beam), which is robust
to source confusion when sources are within a few beam widths.
"""

import math

import numpy as np
import pytest

from katsdpimager_tpu import arguments, frontend, imager as imager_cli
from katsdpimager_tpu import io, loader, simulate


@pytest.fixture(scope="module")
def sim_dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("sim") / "tiny.h5"
    simulate.make_sim_dataset(str(path), num_antennas=16, num_times=24,
                              num_channels=1, max_radius=800.0)
    return str(path)


def run_capture(sim_dataset, argv):
    """Run the pipeline capturing the final image and statistics."""
    parser = imager_cli.get_parser()
    args = parser.parse_args(argv, namespace=arguments.SmartNamespace())
    cap = {}

    class CaptureWriter(frontend.Writer):
        def needs_fits_image(self, name):
            return name == "clean"

        def needs_fits_grid(self, name):
            return False

        def write_fits_image(self, name, desc, ds, image, ip, ch,
                             beam=None, bunit=None):
            cap[name] = np.asarray(image).copy()
            cap["image_p"] = ip

        def write_fits_grid(self, *a, **k):
            pass

        def statistics(self, dataset, channel, **kwargs):
            cap["stats"] = kwargs

    dataset = loader.load(sim_dataset, [])
    try:
        frontend.run(args, dataset, CaptureWriter())
    finally:
        dataset.close()
    return cap


def truth_restored(image_p, pols, rb):
    """Ground truth restored image: the fitted Gaussian beam evaluated
    analytically at the (fractional-pixel) true source positions."""
    ra0, dec0 = simulate.DEFAULT_PHASE_CENTRE
    N = image_p.pixels
    icov = np.linalg.inv(rb.covariance_sqrt() @ rb.covariance_sqrt().T)
    yy, xx = np.meshgrid(np.arange(N, dtype=np.float64),
                         np.arange(N, dtype=np.float64), indexing="ij")
    img = np.zeros((pols, N, N), np.float64)
    for src in simulate.DEFAULT_SOURCES:
        l, m, _ = simulate.lmn(np.array([src.ra]), np.array([src.dec]),
                               ra0, dec0)
        px = N // 2 + l[0] / image_p.pixel_size
        py = N // 2 + m[0] / image_p.pixel_size
        dy, dx = yy - py, xx - px
        g = np.exp(-0.5 * (icov[0, 0] * dy ** 2 + 2 * icov[0, 1] * dy * dx
                           + icov[1, 1] * dx ** 2))
        for p in range(pols):
            img[p] += src.flux_iquv[p] * g
    return img


class TestEndToEnd:
    def test_restored_matches_truth(self, sim_dataset):
        cap = run_capture(sim_dataset, [
            sim_dataset, "/tmp/ignored_%c.fits",
            "--stokes", "I", "--pixels", "1024",
            "--major", "2", "--minor", "300", "--loop-gain", "0.25",
            "--clean-mode", "I", "--kernel-width", "16",
            "--weight-type", "natural",
        ])
        image = cap["clean"]
        rb = cap["stats"]["restoring_beam"]
        expected = truth_restored(cap["image_p"], 1, rb)
        err = image - expected
        # Interior error bounded by the residual noise level (few %)
        assert np.abs(err[:, 100:-100, 100:-100]).max() < 0.15
        # Peak recovery at each source within 10%
        for src in simulate.DEFAULT_SOURCES:
            ra0, dec0 = simulate.DEFAULT_PHASE_CENTRE
            l, m, _ = simulate.lmn(np.array([src.ra]), np.array([src.dec]),
                                   ra0, dec0)
            px = int(round(512 + l[0] / cap["image_p"].pixel_size))
            py = int(round(512 + m[0] / cap["image_p"].pixel_size))
            got = image[0, py - 2:py + 3, px - 2:px + 3].max()
            want = expected[0, py - 2:py + 3, px - 2:px + 3].max()
            assert got == pytest.approx(want, rel=0.1), (src, got, want)

    def test_full_stokes_uniform(self, sim_dataset):
        cap = run_capture(sim_dataset, [
            sim_dataset, "/tmp/ignored_%c.fits",
            "--stokes", "IQUV", "--pixels", "512",
            "--major", "1", "--minor", "200", "--kernel-width", "16",
            "--weight-type", "uniform", "--clean-mode", "IQUV",
        ])
        image = cap["clean"]
        assert image.shape == (4, 512, 512)
        rb = cap["stats"]["restoring_beam"]
        expected = truth_restored(cap["image_p"], 4, rb)
        # Q and U structure recovered with correct sign
        for pol in range(4):
            got = image[pol]
            want = expected[pol]
            scale = max(np.abs(want).max(), 0.1)
            assert np.abs(got - want).max() / scale < 0.35, pol

    def test_robust_weighting(self, sim_dataset):
        """Briggs robust weighting runs end-to-end and recovers the
        phase-centre source (robustness interpolates natural<->uniform)."""
        cap = run_capture(sim_dataset, [
            sim_dataset, "/tmp/ignored_%c.fits",
            "--stokes", "I", "--pixels", "512",
            "--major", "1", "--minor", "150", "--kernel-width", "16",
            "--weight-type", "robust", "--robustness", "0.0",
        ])
        image = cap["clean"]
        assert image[0, 256, 256] == pytest.approx(1.0, rel=0.15)
        assert cap["stats"]["weights_noise"] is not None
        assert cap["stats"]["normalized_noise"] >= 1.0

    def test_cli_writes_fits(self, sim_dataset, tmp_path):
        out = str(tmp_path / "clean_%c.fits")
        rc = imager_cli.main([
            sim_dataset, out,
            "--stokes", "I", "--pixels", "512", "--major", "1",
            "--minor", "100", "--kernel-width", "16",
        ])
        assert rc == 0
        header, data = io.read_fits(str(tmp_path / "clean_0.fits"))
        assert data.shape == (1, 1, 512, 512)
        assert header["CTYPE1"] == "RA---SIN"
        assert header["BUNIT"] == "Jy/beam"
        assert "BMAJ" in header
        assert header["CRVAL1"] == pytest.approx(
            math.degrees(simulate.DEFAULT_PHASE_CENTRE[0]))
        # phase-centre source lands at (N/2, N/2) after undoing the l flip
        image = np.asarray(data[0, 0, :, ::-1], np.float64)
        assert image[256, 256] > 0.5

    def test_statistics_contract(self, sim_dataset):
        """The Writer.statistics call must carry the reference's contract
        fields (frontend.py:429-461)."""
        cap = run_capture(sim_dataset, [
            sim_dataset, "/tmp/ignored_%c.fits", "--pixels", "512",
            "--kernel-width", "16", "--minor", "50",
        ])
        stats = cap["stats"]
        for key in ("noise", "weights_noise", "normalized_noise", "peak",
                    "totals", "major", "minor", "psf_patch_size",
                    "compressed_vis", "image_parameters", "grid_parameters",
                    "clean_parameters"):
            assert key in stats, key
        assert stats["compressed_vis"] > 0
        assert stats["totals"]["I"] == pytest.approx(
            sum(s.flux_iquv[0] for s in simulate.DEFAULT_SOURCES), rel=0.5)


def test_numpy_dataset_images_like_hdf5(tmp_path):
    """The numpy-only dataset directory and the HDF5 file hold the same
    data: each opens with its loader, and both image alike."""
    from katsdpimager_tpu import loader_hdf5, loader_npy

    images = {}
    for suffix, cls in ((".vis", loader_npy.LoaderNumpy),
                        (".h5", loader_hdf5.LoaderHDF5)):
        path = str(tmp_path / ("sim" + suffix))
        simulate.make_sim_dataset(path, num_antennas=12, num_times=16,
                                  num_channels=1, max_radius=600.0)
        ds = loader.load(path)
        assert type(ds) is cls
        ds.close()
        images[suffix] = run_capture(path, [
            path, "/tmp/ignored_%c.fits", "--pixels", "256",
            "--kernel-width", "12", "--minor", "30"])["clean"]
    np.testing.assert_array_equal(images[".vis"], images[".h5"])
