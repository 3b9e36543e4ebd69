"""END-TO-END cube benchmark: dataset -> preprocess -> waves -> FITS.

Measures what BASELINE's channels/s actually means in production —
including the host data plane (load + compress + pack + write), not just
the device wave (VERDICT r2 item 2).  Builds a simulated MeerKAT-like
dataset at a scaled BASELINE point, runs the REAL cube pipeline CLI path
in-process, and reports total wall clock, channels/s, and the host share
from the per-wave timing accounting.

Usage: python benchmarks/cube_e2e.py [pixels] [num_channels] [num_times]
Defaults: 4096 px, 16 channels, 512 dumps x 64 antennas (~1M
visibilities/channel).  Runs only on an NVIDIA GPU.
"""

import logging
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from bench import device_info  # noqa: E402
from katsdpimager_tpu.compile_cache import enable_compilation_cache  # noqa: E402


class _WaveTimes(logging.Handler):
    def __init__(self):
        super().__init__()
        self.host = 0.0
        self.blocked = 0.0
        self.rest = 0.0

    def emit(self, record):
        msg = record.getMessage()
        if "timing: host preprocess+pack" not in msg:
            return
        import re

        m = re.search(r"host preprocess\+pack ([0-9.]+)s \(pipeline "
                      r"blocked ([0-9.]+)s\), device\+write ([0-9.]+)s",
                      msg)
        if m:
            self.host += float(m.group(1))
            self.blocked += float(m.group(2))
            self.rest += float(m.group(3))


def main():
    enable_compilation_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("cube_e2e: needs an NVIDIA GPU")
    pixels = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    channels = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    times = int(sys.argv[3]) if len(sys.argv) > 3 else 512
    ants = 64

    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s:%(name)s: %(message)s")
    from katsdpimager_tpu import simulate

    work = tempfile.mkdtemp(prefix="cube_e2e_")
    ds = os.path.join(work, "sim.vis")
    t0 = time.monotonic()
    simulate.make_sim_dataset(ds, num_antennas=ants, num_times=times,
                              num_channels=channels, max_radius=4000.0)
    t_sim = time.monotonic() - t0
    nvis = times * ants * (ants - 1) // 2
    print(f"dataset: {channels} ch x {nvis} vis "
          f"({t_sim:.1f}s to simulate)")

    handler = _WaveTimes()
    logging.getLogger("katsdpimager_tpu.cube_frontend").addHandler(handler)

    from katsdpimager_tpu import pipeline as pipeline_cli

    out = os.path.join(work, "out")
    argv = [ds, out, "--cube", "--pixels", str(pixels),
            "--kernel-width", "60", "--minor", "1000", "--major", "2",
            "--loop-gain", "0.25",
            # Production-like W geometry (BASELINE: 4 slices): the sim's
            # 4 km baselines at the default --w-step 1.0 would demand
            # >4096 planes/slice, past the packed sort key's 10-bit
            # budget (preprocess.ChannelGeometry); step 8 lands in the
            # production 32-512 planes/slice band.
            "--w-slices", "4", "--w-step", "8"]
    t0 = time.monotonic()
    pipeline_cli.main(argv)
    total = time.monotonic() - t0

    host_share = handler.blocked / total if total else 0.0
    print(device_info())
    print(f"\nEND-TO-END: {total:.1f}s for {channels} channels "
          f"-> {channels / total:.3f} channels/s "
          f"({total / channels:.2f} s/channel incl. host+write)")
    print(f"host preprocess+pack: {handler.host:.1f}s wall, pipeline "
          f"blocked {handler.blocked:.1f}s ({100 * host_share:.0f}% of "
          f"total); device+write {handler.rest:.1f}s")
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
