"""Standalone CLI imager: input dataset -> per-channel FITS cubes.

Parity with the reference ``scripts/imager.py``: the same flag surface plus
debug product dumps (``--write-weights/--write-psf/...``), colorized
logging, and command-line provenance in FITS HISTORY.

Run as ``python -m katsdpimager_tpu.imager input.h5 output.fits`` (the
``%c`` placeholder in the output name substitutes the channel number).
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from . import arguments, frontend, io, loader
from .profiling import Profiler, FlamegraphProfiler

logger = logging.getLogger(__name__)

DEBUG_PRODUCTS = ["weights", "psf", "grid", "dirty", "model", "residuals",
                  "primary_beam"]


def format_channel_filename(template: str, channel: int) -> str:
    """Substitute the channel number: printf-style (``out%05d.fits``,
    reference convention) or the ``%c`` placeholder."""
    if "%c" in template:
        return template.replace("%c", str(channel))
    try:
        return template % channel
    except TypeError:
        return template


class FileWriter(frontend.Writer):
    """Writes FITS products to files derived from the output template."""

    def __init__(self, args):
        self.args = args

    def _filename(self, name, channel):
        if name == "clean":
            template = self.args.output_file
        else:
            template = getattr(self.args, "write_" + name, None)
            if template is None:
                return None
        return format_channel_filename(template, channel)

    def needs_fits_image(self, name):
        return self._filename(name, 0) is not None

    def needs_fits_grid(self, name):
        return self._filename(name, 0) is not None

    def write_fits_image(self, name, description, dataset, image,
                         image_parameters, channel, beam=None,
                         bunit="Jy/beam"):
        filename = self._filename(name, channel)
        if filename is None:
            return
        history = ["Command line: " + " ".join(sys.argv)]
        io.write_fits_image(np.asarray(image), image_parameters, filename,
                            dataset.phase_centre(), beam, bunit,
                            dataset.extra_fits_headers(), history)
        logger.info("Wrote %s to %s", description, filename)

    def write_fits_grid(self, name, description, fftshift, grid_data,
                        image_parameters, channel):
        filename = self._filename(name, channel)
        if filename is None:
            return
        io.write_fits_grid(np.asarray(grid_data), image_parameters, filename)
        logger.info("Wrote %s to %s", description, filename)

    def statistics(self, dataset, channel, **kwargs):
        logger.info("Channel %d: noise=%g peak=%g totals=%s major=%d minor=%d",
                    channel, kwargs.get("noise"), kwargs.get("peak"),
                    kwargs.get("totals"), kwargs.get("major"),
                    kwargs.get("minor"))


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="imager-tpu",
        description="Spectral-line imager on JAX (GPU or CPU)")
    parser.add_argument("input_file", help="Input dataset (.h5 / .ms)")
    parser.add_argument("output_file",
                        help="Output FITS file (%%c = channel number)")
    frontend.add_options(parser)
    group = parser.add_argument_group("Debug output options")
    for name in DEBUG_PRODUCTS:
        if name == "clean":
            continue
        group.add_argument(f"--write-{name.replace('_', '-')}",
                           metavar="FILE",
                           help=f"Write {name} to FITS file")
    group.add_argument("--write-profile", metavar="FILE",
                       help="Write a flamegraph-format profile")
    group.add_argument("--write-device-profile", metavar="FILE",
                       help="Capture an XProf device trace for the run and "
                            "write per-op device times (flamegraph format); "
                            "the raw trace is kept in FILE.trace/ for "
                            "TensorBoard/XProf (reference "
                            "scripts/imager.py:89-92)")
    parser.add_argument("--host", action="store_true",
                        help="Run on the host CPU instead of the accelerator "
                             "(parity with the reference's --host mode)")
    parser.add_argument("--log-level", default="INFO",
                        help="Logging level [%(default)s]")
    return parser


def setup_logging(level: str):
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(levelname)s:%(name)s: %(message)s")


def main(argv=None) -> int:
    parser = get_parser()
    args = parser.parse_args(argv, namespace=arguments.SmartNamespace())
    setup_logging(args.log_level)

    from .compile_cache import enable_compilation_cache

    enable_compilation_cache()

    if args.write_profile:
        Profiler.set_profiler(FlamegraphProfiler())

    import jax

    if args.host:
        jax.config.update("jax_platforms", "cpu")
    if args.precision == "double":
        jax.config.update("jax_enable_x64", True)

    if args.subtract and args.subtract != "auto":
        from . import sky_model

        try:
            sky_model.open_sky_model(args.subtract)
        except (OSError, ValueError) as exc:
            parser.error(f"cannot open sky model {args.subtract}: {exc}")
    try:
        dataset = loader.load(args.input_file, args.input_option,
                              args.start_channel, args.stop_channel)
    except (FileNotFoundError, OSError) as exc:
        parser.error(f"cannot open {args.input_file}: {exc}")
    try:
        writer = FileWriter(args)
        if args.write_device_profile:
            from . import profiling

            trace_dir = args.write_device_profile + ".trace"
            with profiling.device_trace(trace_dir):
                frontend.run(args, dataset, writer)
            totals = profiling.parse_device_profile(trace_dir)
            with open(args.write_device_profile, "w") as f:
                profiling.write_device_profile(totals, f)
            logger.info("Wrote device profile (%d ops) to %s; raw trace "
                        "in %s", len(totals), args.write_device_profile,
                        trace_dir)
        else:
            frontend.run(args, dataset, writer)
    except ValueError as exc:
        parser.error(str(exc))
    finally:
        dataset.close()
        if args.write_profile:
            with open(args.write_profile, "w") as f:
                Profiler.get_profiler().write_flamegraph(f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
