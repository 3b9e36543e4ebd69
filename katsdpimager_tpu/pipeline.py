"""Batch pipeline writer: channel-granularity resume, thumbnails, metadata
and a statistics store.

Parity target: the reference's ``scripts/imager-mkat-pipeline.py`` Writer —
telstate-backed resume and statistics are replaced by a JSON state store in
the output directory (no redis dependency), PNG thumbnails are rendered
with matplotlib, and ``metadata.json`` is written per run.  Output files
land in the output directory atomically (write to a temp name, rename).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile

import numpy as np

from . import frontend, io, metadata

logger = logging.getLogger(__name__)


class StateStore:
    """Per-run persistent key/value store (JSON file; telstate stand-in)."""

    def __init__(self, path: str):
        self._path = path
        self._data = {}
        if os.path.exists(path):
            with open(path) as f:
                self._data = json.load(f)

    def get(self, key: str, default=None):
        return self._data.get(key, default)

    def set(self, key: str, value) -> None:
        self._data[key] = value
        self._flush()

    def _flush(self) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self._path) or ".",
                                   suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self._data, f, indent=2, default=_json_default)
        os.replace(tmp, self._path)


def _json_default(obj):
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


def _thumbnail(image: np.ndarray, filename: str) -> None:
    """Render a PNG thumbnail of the Stokes-I plane."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = image[0]
    finite = data[np.isfinite(data)]
    if finite.size == 0:
        return
    vmax = np.percentile(finite, 99.9)
    vmin = np.percentile(finite, 1)
    fig, ax = plt.subplots(figsize=(4, 4), dpi=64)
    ax.imshow(data, origin="lower", vmin=vmin, vmax=vmax, cmap="viridis")
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(filename)
    plt.close(fig)


class PipelineWriter(frontend.Writer):
    """Writer with channel resume, thumbnails and a statistics store."""

    def __init__(self, output_dir: str, prefix: str = "image",
                 thumbnails: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        self.prefix = prefix
        self.thumbnails = thumbnails
        self.store = StateStore(os.path.join(output_dir, "state.json"))

    # -- resume ---------------------------------------------------------
    def channel_already_done(self, dataset, channel) -> bool:
        return self.store.get(f"status/{channel}") in ("complete", "no-data")

    def skip_channel(self, dataset, image_parameters, channel):
        self.store.set(f"status/{channel}", "no-data")

    # -- products -------------------------------------------------------
    def needs_fits_image(self, name):
        return name == "clean"

    def needs_fits_grid(self, name):
        return False

    def _path(self, name: str, channel) -> str:
        return os.path.join(self.output_dir,
                            f"{self.prefix}_{channel:05d}_{name}.fits")

    def write_fits_image(self, name, description, dataset, image,
                         image_parameters, channel, beam=None,
                         bunit="Jy/beam"):
        path = self._path(name, channel)
        tmp = path + ".writing"
        io.write_fits_image(np.asarray(image), image_parameters, tmp,
                            dataset.phase_centre(), beam, bunit,
                            dataset.extra_fits_headers())
        os.replace(tmp, path)
        logger.info("Wrote %s to %s", description, path)
        if name == "clean" and self.thumbnails:
            try:
                _thumbnail(np.asarray(image), path[:-5] + ".png")
            except Exception:
                logger.warning("Thumbnail rendering failed", exc_info=True)

    def write_fits_grid(self, *args, **kwargs):
        pass

    # -- statistics -----------------------------------------------------
    def statistics(self, dataset, channel, **kwargs):
        stats = {}
        for key, value in kwargs.items():
            if key in ("image_parameters", "grid_parameters",
                       "clean_parameters"):
                stats[key] = str(value)
            elif key == "restoring_beam":
                stats[key] = {"major": value.major, "minor": value.minor,
                              "theta": value.theta}
            else:
                stats[key] = value
        stats["frequency"] = dataset.frequency(channel)
        self.store.set(f"stats/{channel}", stats)
        self.store.set(f"status/{channel}", "complete")

    def finalize(self, dataset, channels) -> None:
        try:
            obs = dataset.observation()
            if obs:
                band = dataset.band()
                if band:
                    obs = dict(obs, band=band)
                self.store.set("observation", {
                    k: (np.asarray(v).tolist()
                        if isinstance(v, (np.ndarray, tuple, list)) else v)
                    for k, v in obs.items()})
        except Exception:
            logger.warning("Could not record observation summary",
                           exc_info=True)
        try:
            image_p = None
            md = metadata.make_metadata(dataset, image_p, list(channels))
            metadata.write_metadata(
                os.path.join(self.output_dir, "metadata.json"), md)
        except Exception:
            logger.warning("Failed to write metadata.json", exc_info=True)


def main(argv=None, devices=None) -> int:
    """Batch pipeline CLI (reference ``imager-mkat-pipeline.py``).
    ``devices`` restricts ``--cube`` mode to a subset of the devices."""
    import argparse
    import sys

    from . import arguments, loader
    from .imager import setup_logging

    parser = argparse.ArgumentParser(
        prog="imager-tpu-pipeline",
        description="Batch spectral-line imaging pipeline with resume")
    parser.add_argument("input_file")
    parser.add_argument("output_dir")
    parser.add_argument("--prefix", default="image")
    parser.add_argument("--no-thumbnails", dest="thumbnails",
                        action="store_false", default=True)
    parser.add_argument("--cube", action="store_true",
                        help="Image channels in sharded device waves "
                             "(production fast path for large cubes)")
    parser.add_argument("--vis-shards", type=int, default=1,
                        help="Devices cooperating per channel in --cube "
                             "mode [%(default)s]")
    parser.add_argument("--cube-psf-patch", type=int, default=0,
                        help="CLEAN PSF patch size in --cube mode; 0 "
                             "auto-sizes per wave from the measured PSF "
                             "[%(default)s]")
    parser.add_argument("--log-level", default="INFO")
    frontend.add_options(parser)
    args = parser.parse_args(argv, namespace=arguments.SmartNamespace())
    setup_logging(args.log_level)

    from .compile_cache import enable_compilation_cache

    enable_compilation_cache()

    if args.cube_psf_patch and (args.cube_psf_patch % 2 == 0
                                or args.cube_psf_patch < 9):
        parser.error("--cube-psf-patch must be 0 (auto) or an odd size "
                     ">= 9 (CLEAN patches are centred on the PSF peak)")
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
        writer = PipelineWriter(args.output_dir, args.prefix, args.thumbnails)
        if args.cube:
            from . import cube_frontend

            cube_frontend.run_cube(args, dataset, writer, devices)
        else:
            frontend.run(args, dataset, writer)
        stop = (args.stop_channel if args.stop_channel is not None
                else dataset.num_channels())
        writer.finalize(dataset, range(args.start_channel, stop))
    finally:
        dataset.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
