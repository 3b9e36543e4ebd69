"""Smoke run of the imager on an NVIDIA GPU, through its command lines.

    python chip_smoke.py                # one card, every phase below
    python chip_smoke.py --four-cards   # the 8k cube on four cards only

Phases, each printing its lines with a ``[phase]`` prefix:

1. device: JAX's devices and version, the card's name and power limit
   (``nvidia-smi`` in a child process that does not import JAX), and the
   compile-cache directory.  Stops with exit code 1 unless JAX's platform
   is ``gpu``.
2. native: builds the C++ preprocessor from the committed source and names
   the preprocess engine the run uses.
3. kernels: each kernel of the main path against its float64 reference at
   real widths (:mod:`katsdpimager_tpu.accuracy`), error beside tolerance.
4. cube: a simulated MeerKAT-64 observation (64 antennas, 3600 dumps,
   4 channels, seed 1) imaged to FITS by ``pipeline --cube`` at 8192
   pixels, K=60, 2 major cycles of at most 1024 minor cycles.
5. per-channel: the same data imaged by ``imager`` at 4096 pixels with
   robust weighting, 2 major cycles, channel 0.
6. tests: the tests marked ``gpu``, in this process.

Phases 4 and 5 check the restored images against the simulated sky: the
four default sources (1.0, 1.5, 1.5, 1.2 Jy Stokes I), so a peak of
1.5 Jy and a total of 5.2 Jy.  Each source's restored peak must lie within
10% of its flux plus five times the image noise: the simulation adds no
thermal noise, so what remains is CLEAN's depth (two major cycles at
major gain 0.85 leave ~2% of each source in the residual) and the
restored peak of a source that falls between pixels (up to ~5% low at
about five pixels per beam).  The total (the image sum over the beam
area) also integrates the residual over every pixel, so its tolerance
adds three times that sum's noise, noise * sqrt(pixels / beam area):
about 0.6 Jy at 8k.

``--four-cards`` runs phase 1 and then the cube of phase 4 on a 4x1 mesh
(four channels in one wave) and on a 2x2 mesh (``--vis-shards 2``: two
channels per wave, each channel's grids summed over two cards), and
compares both with the same channels imaged on one of the four cards in
this process.

Data and outputs go to ``build/smoke`` (listed in .gitignore).  A failed
phase ends the run with a non-zero exit; the last line of standard output,
printed only on success, is the JSON result.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "build", "smoke")

#: The simulated observation (simulate.make_sim_dataset arguments).
SIM = dict(num_antennas=64, num_times=3600, num_channels=4,
           max_radius=4000.0, seed=1)
#: Command-line options of the two imaging paths.
CUBE_OPTIONS = ["--cube", "--pixels", "8192", "--kernel-width", "60",
                "--major", "2", "--minor", "1024", "--no-thumbnails"]
PER_CHANNEL_OPTIONS = ["--pixels", "4096", "--kernel-width", "60",
                       "--weight-type", "robust", "--major", "2",
                       "--stop-channel", "1"]
#: (pixels, polarizations, visibilities) of the kernel checks.
KERNEL_CASES = ((4096, 1, 1 << 18), (4096, 4, 1 << 17),
                (8192, 1, 1 << 18), (8192, 4, 1 << 17))
FFT_CASES = ((4096, 4), (8192, 1))

#: Stokes I of simulate.DEFAULT_SOURCES, brightest first.
EXPECTED_FLUXES = (1.5, 1.5, 1.2, 1.0)
EXPECTED_TOTAL = sum(EXPECTED_FLUXES)
FLUX_REL_TOL = 0.10
NOISE_SIGMAS = 5.0


class PhaseError(RuntimeError):
    pass


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


class CompileClock:
    """Sums JAX's own tracing, lowering and backend-compile durations."""

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, event, duration, **_kwargs):
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration


class WaveClock(logging.Handler):
    """Collects the cube frontend's per-wave seconds per channel."""

    def __init__(self):
        super().__init__()
        self.per_channel = []

    def emit(self, record):
        m = re.search(r"-> ([0-9.]+) s/channel", record.getMessage())
        if m:
            self.per_channel.append(float(m.group(1)))


class ChannelStats(logging.Handler):
    """Collects the per-channel imager's ``Channel N: noise=...`` line."""

    def __init__(self):
        super().__init__()
        self.stats = {}

    def emit(self, record):
        if record.getMessage().startswith("Channel ") and record.args:
            channel, noise, peak, totals = record.args[:4]
            self.stats[channel] = dict(noise=noise, peak=peak, totals=totals)


def brightest_sources(image, count: int = 4, radius: int = 24):
    """Values of the ``count`` brightest local maxima of a 2-D image, at
    least ``radius`` pixels apart."""
    import numpy as np

    img = np.nan_to_num(np.array(image, np.float64), nan=-np.inf)
    found = []
    for _ in range(count):
        y, x = np.unravel_index(np.argmax(img), img.shape)
        found.append(float(img[y, x]))
        img[max(0, y - radius):y + radius + 1,
            max(0, x - radius):x + radius + 1] = -np.inf
    return found


def check_sky(phase: str, fits_path: str, peak: float, total: float,
              noise: float) -> None:
    """Recovered fluxes against the simulated sky (module docstring)."""
    from katsdpimager_tpu import io

    hdr, data = io.read_fits(fits_path)
    import numpy as np

    image = np.asarray(data)
    while image.ndim > 2:
        image = image[0]
    beam_px = (np.pi / (4 * np.log(2)) * hdr["BMAJ"] * hdr["BMIN"]
               / hdr["CDELT2"] ** 2)
    total_noise = noise * np.sqrt(image.size / beam_px)
    fluxes = brightest_sources(image)
    bad = []
    for got, want in zip(fluxes, EXPECTED_FLUXES):
        if abs(got - want) > FLUX_REL_TOL * want + NOISE_SIGMAS * noise:
            bad.append((got, want))
    tol_peak = FLUX_REL_TOL * EXPECTED_FLUXES[0] + NOISE_SIGMAS * noise
    tol_total = FLUX_REL_TOL * EXPECTED_TOTAL + 3 * total_noise
    if abs(peak - EXPECTED_FLUXES[0]) > tol_peak:
        bad.append(("peak", peak))
    if abs(total - EXPECTED_TOTAL) > tol_total:
        bad.append(("total", total))
    say(phase, f"{os.path.basename(fits_path)}: sources "
        f"{[round(f, 4) for f in fluxes]} Jy (want {list(EXPECTED_FLUXES)} "
        f"+-{FLUX_REL_TOL:.0%}+{NOISE_SIGMAS:g}*noise) peak={peak:.4f} "
        f"(tol {tol_peak:.3f}) total_I={total:.4f} (tol {tol_total:.3f}) "
        f"noise={noise:.3g}")
    if bad:
        raise PhaseError(f"{fits_path}: sky not recovered: {bad}")


def peak_bytes() -> int:
    import jax

    return max(d.memory_stats().get("peak_bytes_in_use", 0)
               for d in jax.local_devices())


def make_dataset() -> str:
    """The simulated observation of phases 4 and 5, made from its seed."""
    from katsdpimager_tpu import simulate

    path = os.path.join(DATA, "meerkat64_4ch.vis")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.monotonic()
    simulate.make_sim_dataset(path, **SIM)
    ants = SIM["num_antennas"]
    say("data", f"simulated {ants} antennas x {SIM['num_times']} dumps x "
        f"{SIM['num_channels']} channels "
        f"({ants * (ants - 1) // 2 * SIM['num_times']} visibilities/channel)"
        f" in {time.monotonic() - t0:.1f}s -> {path}")
    return path


def run_cube(dataset: str, out: str, clock: CompileClock, extra=(),
             devices=None) -> dict:
    from katsdpimager_tpu import pipeline

    shutil.rmtree(out, ignore_errors=True)
    waves = WaveClock()
    logging.getLogger("katsdpimager_tpu.cube_frontend").addHandler(waves)
    c0 = clock.seconds
    t0 = time.monotonic()
    try:
        rc = pipeline.main([dataset, out] + CUBE_OPTIONS + list(extra),
                           devices=devices)
    finally:
        logging.getLogger("katsdpimager_tpu.cube_frontend").removeHandler(
            waves)
    if rc:
        raise PhaseError(f"pipeline exited with {rc}")
    with open(os.path.join(out, "state.json")) as f:
        state = json.load(f)
    return dict(wall=time.monotonic() - t0, compile=clock.seconds - c0,
                waves=waves.per_channel, state=state)


def phase_device(four_cards: bool):
    import jax

    from katsdpimager_tpu.compile_cache import enable_compilation_cache

    cache = enable_compilation_cache()
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX platform is {dev.platform!r}, not 'gpu'; "
              "this script runs only on an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    if four_cards and len(devices) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found "
              f"{len(devices)}", file=sys.stderr)
        sys.exit(1)
    say("1 device", f"devices={devices} kind={dev.device_kind!r} "
        f"count={len(devices)} jax={jax.__version__} "
        f"nvidia-smi: {nvidia_smi()} compile_cache={cache}")
    return dev, len(devices)


def phase_native():
    from katsdpimager_tpu import frontend, native

    t0 = time.monotonic()
    path = native.build()
    built = time.monotonic() - t0
    native.load()
    engine = frontend.preprocess_engine("auto")
    say("2 native", f"library={os.path.relpath(path, ROOT)} "
        f"build_s={built:.1f} engine={engine}")
    if engine != "native":
        raise PhaseError("the native preprocess engine is not in use")


def phase_kernels():
    from katsdpimager_tpu import accuracy

    checks = []
    t0 = time.monotonic()
    for pixels, pols, n_vis in KERNEL_CASES:
        work = accuracy.make_workload(pixels, pols, n_vis)
        checks.extend(accuracy.check_grid(work))
        checks.append(accuracy.check_degrid(work))
        if (pixels, pols) in FFT_CASES:
            checks.extend(accuracy.check_fft(work))
    checks.append(accuracy.check_predict())
    for c in checks:
        say("3 kernels", c.line())
    say("3 kernels", f"{len(checks)} checks in {time.monotonic() - t0:.1f}s "
        f"(compile included) peak_bytes_in_use={peak_bytes()}")
    failed = [c.name for c in checks if not c.ok]
    if failed:
        raise PhaseError(f"kernel checks failed: {failed}")


def report_cube(phase: str, run: dict, out: str, channels) -> None:
    steady = run["waves"][1:] or run["waves"]
    say(phase, f"wall={run['wall']:.1f}s compile={run['compile']:.1f}s "
        f"s_per_channel_by_wave={run['waves']} "
        f"steady_s_per_channel={sum(steady) / len(steady):.2f} "
        f"peak_bytes_in_use={peak_bytes()} (process high-water mark)")
    for ch in channels:
        stats = run["state"][f"stats/{ch}"]
        check_sky(phase, os.path.join(out, f"image_{ch:05d}_clean.fits"),
                  stats["peak"], stats["totals"]["I"], stats["noise"])


def phase_cube(dataset: str, clock: CompileClock):
    out = os.path.join(DATA, "cube")
    run = run_cube(dataset, out, clock)
    report_cube("4 cube", run, out, range(4))


def phase_per_channel(dataset: str, clock: CompileClock):
    from katsdpimager_tpu import imager

    out = os.path.join(DATA, "per_channel")
    argv = [dataset, os.path.join(out, "out_%c.fits")] + PER_CHANNEL_OPTIONS
    runs = []
    for _ in range(2):   # cold (compiles), then warm (steady state)
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        stats = ChannelStats()
        logging.getLogger("katsdpimager_tpu.imager").addHandler(stats)
        c0 = clock.seconds
        t0 = time.monotonic()
        try:
            rc = imager.main(argv)
        finally:
            logging.getLogger("katsdpimager_tpu.imager").removeHandler(stats)
        if rc:
            raise PhaseError(f"imager exited with {rc}")
        runs.append((time.monotonic() - t0, clock.seconds - c0, stats))
    (cold, cold_compile, _), (warm, warm_compile, stats) = runs
    say("5 per-channel", f"cold_wall={cold:.1f}s compile={cold_compile:.1f}s "
        f"steady_s_per_channel={warm:.2f} (warm rerun, compile "
        f"{warm_compile:.1f}s) peak_bytes_in_use={peak_bytes()} "
        "(process high-water mark)")
    st = stats.stats[0]
    check_sky("5 per-channel", os.path.join(out, "out_0.fits"), st["peak"],
              st["totals"]["I"], st["noise"])


def phase_tests():
    import pytest

    # The caller owns the JAX platform (tests/conftest.py leaves it alone
    # unless the CPU is asked for); the tests marked gpu find the card in
    # their fixture.
    os.environ["JAX_PLATFORMS"] = "cuda"
    t0 = time.monotonic()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")])
    say("6 tests", f"pytest -m gpu exit={int(rc)} in "
        f"{time.monotonic() - t0:.1f}s")
    if rc != 0:
        raise PhaseError(f"on-card tests failed (pytest exit {int(rc)})")


def phase_four_cards(dataset: str, clock: CompileClock):
    import jax
    import numpy as np

    from katsdpimager_tpu import io

    phase = "4 four-cards"
    runs = {}
    for name, extra, devices in (("1 card", (), jax.devices()[:1]),
                                 ("4x1", (), None),
                                 ("2x2", ("--vis-shards", "2"), None)):
        out = os.path.join(DATA, "four_cards", name.replace(" ", "_"))
        run = run_cube(dataset, out, clock, extra, devices)
        runs[name] = (out, run)
        say(phase, f"{name}: wall={run['wall']:.1f}s "
            f"compile={run['compile']:.1f}s "
            f"s_per_channel_by_wave={run['waves']}")
        for ch in range(4):
            stats = run["state"][f"stats/{ch}"]
            check_sky(phase, os.path.join(out, f"image_{ch:05d}_clean.fits"),
                      stats["peak"], stats["totals"]["I"], stats["noise"])
    ref_out, ref_run = runs["1 card"]
    bad = []
    for name in ("4x1", "2x2"):
        out, run = runs[name]
        for ch in range(4):
            fits = f"image_{ch:05d}_clean.fits"
            a = np.asarray(io.read_fits(os.path.join(out, fits))[1])
            b = np.asarray(io.read_fits(os.path.join(ref_out, fits))[1])
            peak = float(np.nanmax(np.abs(b)))
            noise = ref_run["state"][f"stats/{ch}"]["noise"]
            diff = float(np.nanmax(np.abs(a - b)))
            # Reduction order differs across meshes, and CLEAN's argmax
            # may then pick the other of two near-equal pixels; the
            # restored images must still agree within the image noise.
            tol = max(1e-5 * peak, noise)
            say(phase, f"{name} vs 1 card, channel {ch}: max|diff|="
                f"{diff:.3e} (peak {peak:.4f}, tolerance {tol:.3e})")
            if not diff <= tol:
                bad.append((name, ch, diff, tol))
    if bad:
        raise PhaseError(f"four-card cubes differ from one card: {bad}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four_cards = "--four-cards" in argv
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s:%(name)s: %(message)s")
    dev, count = phase_device(four_cards)

    import jax.monitoring

    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    os.makedirs(DATA, exist_ok=True)
    if four_cards:
        phase_native()
        phase_four_cards(make_dataset(), clock)
    else:
        phase_native()
        phase_kernels()
        dataset = make_dataset()
        phase_cube(dataset, clock)
        phase_per_channel(dataset, clock)
        phase_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
